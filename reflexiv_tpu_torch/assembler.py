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
from .count import count_kmers_auto
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


def _n_true(mask) -> int:
    """True entries of a mask, or of a list of per-shard masks."""
    if isinstance(mask, list):
        return sum(int(m.sum()) for m in mask)
    return int(mask.sum())


def compact_quarter(p, live_n: int):
    """``p`` with its live rows first and cut to ``max(next_pow2(live_n),
    16)`` rows when at most a quarter of more than 64 rows is live."""
    cap = p.capacity
    if live_n <= cap // 4 and cap > 64:
        return pk.compact_packed(p, max(next_pow2(live_n), 16))
    return p


def extension_fixpoint(p, step, finished, park, params: Params
                       ) -> Tuple[list, int]:
    """The loop control of ``assembler._run_extension_loop_packed`` over
    any pool with ``live`` (a mask, or a list of per-shard masks) and
    ``capacity``: ``step(p, it, live_n)`` runs round ``it`` on a pool with
    ``live_n`` live rows and returns ``(pool, live count)``,
    ``finished(p)`` is the census (a mask like ``live``),
    ``park(p, fin, parked)`` moves rows out.

    Stop rules: once the live count has been stable for a multiple of 3
    rounds, stop if no live record has a potential partner left (the
    census, ``ReflexivDSMain.java:297-326``); from ``min_iterations`` on,
    stop after 12 stable rounds. Every 8th round parks finished rows when
    there are more than max(32, capacity / 8). Returns the pool, then the
    parked batches; and the rounds run."""
    stable_rounds = 0
    n = prev_count = _n_true(p.live)
    parked: list = []
    it = 0
    for it in range(1, params.max_iterations + 1):
        p, live_n = step(p, it, n)
        n = int(live_n)
        if n == prev_count:
            stable_rounds += 1
        else:
            stable_rounds = 0
            prev_count = n
        if stable_rounds >= 3 and stable_rounds % 3 == 0:
            if _n_true(finished(p)) == n:
                break
        if it >= params.min_iterations and stable_rounds >= 12:
            break
        if it % 8 == 0:
            fin = finished(p)
            n_fin = _n_true(fin)
            if n_fin > max(32, p.capacity // 8):
                p = park(p, fin, parked)
                n -= n_fin
                prev_count = n
    return [p] + parked, it


def run_extension_loop(recs: Records, params: Params, *, seed: int = 0
                       ) -> List[pk.PackedRecords]:
    """Iterate packed sort -> join rounds until fixpoint or
    ``max_iterations`` (:func:`extension_fixpoint`), compacting the pool at
    quarter occupancy (live rows first, in row order) and growing its width
    before a round whose longest merge may not fit. Counts
    ``run/extension_rounds``.

    Returns the pool, then the parked batches: the rows in the order the
    JAX package's ``merge_parked_packed`` lays them out, without merging
    them into one matrix as wide as the longest row (with many parked
    rows, as a mercy table's error tips give, that matrix would not fit)."""
    k = params.k
    p = pk.from_records(recs)
    need = 2 * int(torch.where(p.live, p.length, 0).max()) - (k - 1)

    def step(p, it, live_n):
        nonlocal need
        p = compact_quarter(p, live_n)
        if need > p.base_capacity:
            p = pk.grow_packed(p, next_pow2(need))
        p, live_n, need_t = pk.extension_round_packed(p, seed + it, k=k)
        need = int(need_t)
        return p, live_n

    groups, it = extension_fixpoint(
        p, step, lambda p: pk.finished_mask_packed(p, k),
        pk.park_finished_rows, params)
    metrics.current().set("run/extension_rounds", it)
    return groups


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
    groups = run_extension_loop(recs, params, seed=seed)
    _lap("run/extension", device)
    contigs = emit_contigs(groups, min_contig=params.min_contig)
    _lap("run/emit", device)
    log.info("emitted %d contigs >= %d bp", len(contigs), params.min_contig)
    return contigs


def assemble_reads(
    bases, lengths, params: Params, *, seed: int = 0, device,
) -> List[Tuple[str, str]]:
    """Full single-k assembly from a read code matrix (numpy or tensors);
    the count streams in row chunks past one pass's windows or under
    ``-partition`` (:func:`count.count_kmers_auto`)."""
    params.validate()
    device = resolve_device(device)
    keys, counts = count_kmers_auto(
        bases, lengths, k=params.k, min_cov=params.min_kmer_coverage,
        max_cov=params.max_kmer_coverage, front_clip=params.front_clip,
        end_clip=params.end_clip, partitions=params.partitions,
        device=device)
    log.info("counted %d solid canonical %d-mers", counts.numel(), params.k)
    met = metrics.current()
    _lap("run/counting", device)
    met.set("run/solid_kmers", counts.numel())
    out = assemble_from_counts(keys, counts, params, seed=seed, device=device)
    met.set("run/contigs", len(out))
    return out
