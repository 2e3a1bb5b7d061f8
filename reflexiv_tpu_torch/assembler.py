"""Single-k assembly: ``reflexiv run`` in PyTorch (``reflexiv_tpu.assembler``).

reads -> canonical k-mer count -> coverage filter -> RC expansion -> fork
filters -> extension rounds to fixpoint -> contigs, the flow of
``ReflexivDSMain.assembly`` (``ReflexivDSMain.java:123-357``). Every tensor
lives on the ``device`` the caller names; the host loop reads two scalars
per round.
"""
from __future__ import annotations

import logging
from typing import List, Tuple

import torch

from . import metrics
from . import packed as pk
from .contigs import emit_contigs
from .count import count_kmers
from .device import resolve_device, synchronize
from .graph import build_initial_records
from .params import Params
from .records import Records, compact, next_pow2

log = logging.getLogger("reflexiv_tpu_torch")


def _lap(name: str, device: torch.device) -> None:
    synchronize(device)
    metrics.current().lap(name)


def initial_records_from_counts(
    keys: torch.Tensor, counts: torch.Tensor, params: Params
) -> Tuple[Records, int]:
    """Counted k-mers -> compacted, fork-filtered record set."""
    recs = build_initial_records(
        keys, counts, k=params.k, min_error=params.min_error_coverage,
        bubble=params.bubble)
    n_live = int(recs.live.sum())
    return compact(recs, max(next_pow2(n_live), 16)), n_live


def run_extension_loop(recs: Records, params: Params, *, seed: int = 0
                       ) -> Records:
    """Iterate packed sort -> join rounds until fixpoint or
    ``max_iterations`` (``assembler._run_extension_loop_packed``).

    Stop rules: once the live count has been stable for a multiple of 3
    rounds, stop if no live record has a potential partner left (the
    census, ``ReflexivDSMain.java:297-326``); from ``min_iterations`` on,
    stop after 12 stable rounds. Every 8th round parks finished rows when
    there are more than max(32, capacity / 8); the pool compacts at quarter
    occupancy."""
    k = params.k
    p = pk.from_records(recs)
    stable_rounds = 0
    prev_count = int(p.live.sum())
    need = 2 * int(torch.where(p.live, p.length, 0).max()) - (k - 1)
    parked: list = []
    it = 0
    for it in range(1, params.max_iterations + 1):
        if need > p.base_capacity:
            p = pk.grow_packed(p, next_pow2(need))
        p, live_n, need_t = pk.extension_round_packed(p, seed + it, k=k)
        n = int(live_n)
        need = int(need_t)
        if n == prev_count:
            stable_rounds += 1
        else:
            stable_rounds = 0
            prev_count = n
        if stable_rounds >= 3 and stable_rounds % 3 == 0:
            fin = pk.finished_mask_packed(p, k)
            if int(fin.sum()) == n:
                break
        if it >= params.min_iterations and stable_rounds >= 12:
            break
        if it % 8 == 0:
            fin = pk.finished_mask_packed(p, k)
            n_fin = int(fin.sum())
            if n_fin > max(32, p.capacity // 8):
                p = pk.park_finished_rows(p, fin, parked)
                n -= n_fin
                prev_count = n
        cap = p.capacity
        if n <= cap // 4 and cap > 64:
            p = pk.compact_packed(p, max(next_pow2(n), 16))

    metrics.current().set("run/extension_rounds", it)
    if parked:
        p = pk.merge_parked_packed(p, parked)
    return pk.to_records(p)


def assemble_from_counts(
    keys: torch.Tensor, counts: torch.Tensor, params: Params, *,
    seed: int = 0, device,
) -> List[Tuple[str, str]]:
    """Counted canonical k-mers (int64 keys, int32 counts) -> contigs."""
    device = resolve_device(device)
    keys = keys.to(device)
    counts = counts.to(device)
    recs, n_live = initial_records_from_counts(keys, counts, params)
    log.info("fork-filtered records: %d (from %d canonical k-mers)",
             n_live, counts.numel())
    metrics.current().set("run/fork_filtered_records", n_live)
    _lap("run/graph", device)
    recs = run_extension_loop(recs, params, seed=seed)
    _lap("run/extension", device)
    contigs = emit_contigs(recs, min_contig=params.min_contig)
    _lap("run/emit", device)
    log.info("emitted %d contigs >= %d bp", len(contigs), params.min_contig)
    return contigs


def assemble_reads(
    bases, lengths, params: Params, *, seed: int = 0, device,
) -> List[Tuple[str, str]]:
    """Full single-k assembly from a read code matrix (numpy or tensors)."""
    params.validate()
    device = resolve_device(device)
    keys, counts = count_kmers(
        bases, lengths, k=params.k, min_cov=params.min_kmer_coverage,
        max_cov=params.max_kmer_coverage, front_clip=params.front_clip,
        end_clip=params.end_clip, device=device)
    log.info("counted %d solid canonical %d-mers", counts.numel(), params.k)
    met = metrics.current()
    _lap("run/counting", device)
    met.set("run/solid_kmers", counts.numel())
    out = assemble_from_counts(keys, counts, params, seed=seed, device=device)
    met.set("run/contigs", len(out))
    return out
