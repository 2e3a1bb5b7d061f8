"""The ``reduce`` command: per-k counting, fork filtering and pairwise
reduction along the k ladder (PyTorch counterpart of the reduce half of
``reflexiv_tpu.dynamic``; ``meta``'s mixed-k extension is not ported yet).

  * **per-k sorting** (``ReflexivDSKmerLeftAndRightSorting``): counted
    k-mers -> RC expansion + both-direction fork filters -> full k-mers
    annotated with (left, right), :func:`sort_k_records`;
  * **pairwise (k1, k2) reduction** (``ReflexivDSDynamicKmerRuduction``),
    :func:`reduce_k_pair`: pass A (right-end variant adjustment), pass B
    (left-end mirror + neutralization of matching shorts), pass C (prefix
    subsumption). The byte pool stays in host memory, as in the JAX
    package; each pass uploads the window bytes it groups on, and the
    device packs them into keys, sorts and segments.

Every sort here is stable with the JAX package's key sequence: which short
row of a group supplies the variant base (pass A/B) and which row is a
row's successor (pass C) depend on the order within equal keys, and the
JAX CPU ``lexsort`` keeps original index order there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import logging
import os
import shutil
import time
from typing import Tuple

import numpy as np
import torch

from . import metrics
from .bitpack import (BASES_PER_WORD, check_k, encode_ascii, group_sentinel,
                      pack_bases, where_live, word_bases)
from .count import count_kmers_auto
from .device import resolve_device, synchronize
from .graph import build_initial_records
from .io import has_success_marker, write_success_marker
from .join_core import first_per_segment, lexsort_rows, segments
from .kmer_io import (part_files, read_count_table, write_count_table,
                      write_rows)
from .params import Params

log = logging.getLogger("reflexiv_tpu_torch")

Triple = Tuple[np.ndarray, np.ndarray, np.ndarray]   # (bases, left, right)


# ---------------------------------------------------------------------------
# per-k sorting stage
# ---------------------------------------------------------------------------

def sort_k_records(keys: torch.Tensor, counts: torch.Tensor, k: int,
                   params: Params) -> Triple:
    """Counted k-mers -> (bases (M, k) uint8, left (M,), right (M,))
    survivors on the host (``dynamic.sort_k_records``): both fork filters,
    the annotated full k-mer set of both strands, in the graph's row
    order."""
    recs = build_initial_records(
        keys, counts, k=k, min_error=params.min_error_for_k(k),
        bubble=params.bubble)
    live = recs.live
    return (recs.seq[live][:, :k].cpu().numpy(),
            recs.left[live].cpu().numpy(), recs.right[live].cpu().numpy())


# ---------------------------------------------------------------------------
# pairwise reduction
# ---------------------------------------------------------------------------

def _inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return inv


def _segments_from_keys(keys: torch.Tensor, live: torch.Tensor, width: int):
    """Stable sort of ``width``-base keys (dead rows keyed as the JAX
    all-ones limbs) -> (order, seg) (``dynamic._segments_from_keys``)."""
    keyed = where_live(live, keys, group_sentinel(width))
    order = lexsort_rows(keyed)
    _is_start, seg = segments(keyed[order])
    return order, seg


def _variant_pass(keys, length, attr, var, live, *, k1: int, width: int,
                  anchor: str):
    """One variant-adjustment pass (``dynamic._variant_pass_device``): A
    (``anchor='right'``) or B (``'left'``, which also plans the drops).
    ``keys`` are the packed ``width``-base windows. Returns, in original
    row order: (new_attr, edit_mask, edit_val, drop)."""
    N = length.shape[0]
    order, seg = _segments_from_keys(keys, live, width)
    slen, sattr, slive, svar = length[order], attr[order], live[order], \
        var[order]
    is_short = slive & (slen == k1)
    is_long = slive & (slen > k1)

    # the first short of each group supplies the variant base and the end's
    # extendability
    first_short = first_per_segment(seg, is_short, N)
    has_short = first_short < N
    fs = first_short.clamp(max=N - 1)
    short_attr, short_var = sattr[fs], svar[fs]

    # a long blocked on a fork the short resolves inherits extendability
    # and the short's variant base
    resolves = is_long & has_short & (short_attr < 0) & (sattr >= 0)
    new_attr = torch.where(resolves, -1, sattr).to(torch.int32)
    new_var = torch.where(resolves, short_var, svar)

    drop = torch.zeros(N, dtype=torch.bool, device=length.device)
    if anchor == "left":
        # drop shorts whose variant base matches any long's (adjusted) base
        onehot = (torch.arange(4, device=length.device)[None, :]
                  == new_var[:, None]) & is_long[:, None]
        long_bases = torch.zeros((N, 4), dtype=torch.int32,
                                 device=length.device)
        long_bases.scatter_reduce_(0, seg[:, None].expand(N, 4),
                                   onehot.to(torch.int32), "amax")
        own = long_bases[seg].gather(1, svar[:, None]).squeeze(1)
        drop = is_short & (own > 0)

    inv = _inverse(order)
    return new_attr[inv], resolves[inv], new_var[inv], drop[inv]


def _subsume_pass(keys, length, live, *, k: int):
    """Pass C, prefix subsumption (``dynamic._subsume_pass_device``): sort
    by (key, length); a live row is contained iff its sorted successor is
    live, longer and agrees on the row's first ``length`` bases (pad code
    0 = 'A' sorts a short key right before a longer key sharing its
    prefix)."""
    keyed = where_live(live, keys, group_sentinel(k))
    order = lexsort_rows(keyed, length)
    slen, slive, skey = length[order], live[order], keyed[order]
    if skey.dim() == 1:
        skey = skey[:, None]
    nxt_key = torch.roll(skey, -1, 0)
    nxt_len = torch.roll(slen, -1)
    nxt_live = torch.roll(slive, -1)
    same = torch.ones_like(slive)
    for w, n in enumerate(word_bases(k)):
        c = (slen.to(torch.int64) - BASES_PER_WORD * w).clamp(0, n)
        mask = ((torch.ones_like(c) << (2 * c)) - 1) << (2 * (n - c))
        same &= ((skey[:, w] ^ nxt_key[:, w]) & mask) == 0
    contained = slive & nxt_live & (nxt_len > slen) & same
    return (slive & ~contained)[_inverse(order)]


def _pack_on(device, win: np.ndarray, width: int) -> torch.Tensor:
    """Upload a ``(N, width)`` window of the host pool and pack it."""
    return pack_bases(torch.from_numpy(np.ascontiguousarray(win)).to(device),
                      width)


def reduce_k_pair(shorts: Triple, longs: Triple, k1: int, k2: int, *,
                  device) -> Tuple[Triple, Triple]:
    """Reduce (k1_sorted, k2_sorted) -> (k1_reduced, k2_adjusted)
    (``dynamic.reduce_k_pair``, ``ReflexivDSDynamicKmerRuduction
    .assemblyFromKmer`` ``:143-287``). Each side is (bases, left, right)
    on the host.

    The byte pool stays in host memory; each pass uploads the window bytes
    it groups on plus per-row scalars, and the variant-base writes between
    passes go to the host pool."""
    device = resolve_device(device)
    b1, l1, r1 = shorts
    b2, l2, r2 = longs
    n1, n2 = len(b1), len(b2)
    N, L = n1 + n2, k2
    width = k1 - 1
    seq = np.zeros((N, L), dtype=np.uint8)   # short rows padded with A
    seq[:n1, :k1] = b1
    seq[n1:, :k2] = b2
    length = np.concatenate(
        [np.full(n1, k1, np.int32), np.full(n2, k2, np.int32)])
    left = np.concatenate([l1, l2]).astype(np.int32)
    right = np.concatenate([r1, r2]).astype(np.int32)
    live = np.ones(N, dtype=bool)
    len_d = torch.from_numpy(length).to(device)
    live_d = torch.ones(N, dtype=torch.bool, device=device)

    def var_of(col):
        return torch.from_numpy(np.ascontiguousarray(col)).to(device) \
            .to(torch.int64)

    # pass A: right-end variant adjustment
    # short key: bases [0, k1-1); long key: bases [L-k1, L-1)
    win = np.empty((N, width), np.uint8)
    win[:n1] = seq[:n1, :width]
    win[n1:] = seq[n1:, L - k1: L - 1]
    var = np.concatenate([seq[:n1, k1 - 1], seq[n1:, L - 1]])
    new_right, edit, edit_val, _ = _variant_pass(
        _pack_on(device, win, width), len_d,
        torch.from_numpy(right).to(device), var_of(var), live_d,
        k1=k1, width=width, anchor="right")
    del win
    right = new_right.cpu().numpy()
    rows = torch.nonzero(edit).squeeze(1).cpu().numpy()
    seq[rows, length[rows] - 1] = edit_val[edit].cpu().numpy()

    # pass B: left-end variant adjustment + matching-short drop
    new_left, edit, edit_val, drop = _variant_pass(
        _pack_on(device, seq[:, 1:k1], width), len_d,
        torch.from_numpy(left).to(device), var_of(seq[:, 0]), live_d,
        k1=k1, width=width, anchor="left")
    left = new_left.cpu().numpy()
    rows = torch.nonzero(edit).squeeze(1).cpu().numpy()
    seq[rows, 0] = edit_val[edit].cpu().numpy()
    live &= ~drop.cpu().numpy()

    # pass C: prefix subsumption on the full k2-mer (rows are A-padded past
    # their length; the edits only touch in-length positions)
    live = _subsume_pass(_pack_on(device, seq, k2), len_d,
                         torch.from_numpy(live).to(device), k=k2) \
        .cpu().numpy()

    keep1, keep2 = live[:n1], live[n1:]
    shorts_out = (seq[:n1][keep1][:, :k1], left[:n1][keep1],
                  right[:n1][keep1])
    longs_out = (seq[n1:][keep2][:, :k2], left[n1:][keep2],
                 right[n1:][keep2])
    return shorts_out, longs_out


# ---------------------------------------------------------------------------
# the reduce command with stage checkpoints
# ---------------------------------------------------------------------------

def _count_signature(params: Params) -> dict:
    """The parameter fields that determine counting/sorting/reduction
    artifacts; reusing ``Count_*`` tables is only valid when these match."""
    return {
        "klist": sorted(params.klist),
        "min_cov": params.min_kmer_coverage,
        "max_cov": params.max_kmer_coverage,
        "min_error": params.min_error_coverage,
        "sensitive": params.sensitive,
        "front_clip": params.front_clip,
        "end_clip": params.end_clip,
        "min_read_length": params.min_read_length,
        "read_limit": params.read_limit,
        "bubble": params.bubble,
    }


def _guard_reduce_signature(out: str, params: Params) -> None:
    """Discard reduce artifacts written under other parameters, so a rerun
    with changed coverage or klist never resumes on stale tables."""
    sig = _count_signature(params)
    sig_path = os.path.join(out, "reduce_params.json")
    if os.path.exists(sig_path):
        with open(sig_path) as fh:
            old = json.load(fh)
        if old != sig:
            log.info("reduce params changed; discarding stale Count_* "
                     "artifacts")
            for name in os.listdir(out):
                if name.startswith("Count_") or name == "Stitch_kmer":
                    shutil.rmtree(os.path.join(out, name), ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    with open(sig_path, "w") as fh:
        json.dump(sig, fh)


@contextlib.contextmanager
def _lap(name: str, device):
    """Add the wall time of the block to ``reduce/<name>`` in metrics.json
    (summed over the ladder), the device synchronized at both ends."""
    synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        synchronize(device)
        metrics.current().add_time(f"reduce/{name}", time.perf_counter() - t0)


def dynamic_reduction(params: Params, *, seed: int = 0, device,
                      plain: bool = False) -> None:
    """``reduce`` command (``dynamic.dynamic_reduction``): per-k count +
    sort + pairwise reduce, with per-artifact ``_SUCCESS``-marker resume
    (cf. ``Pipelines.java:1315-1737``):

      * ``Count_<k>_sorted/_SUCCESS`` present -> skip counting AND sorting
        k, read the table back;
      * else ``Count_<k>/_SUCCESS`` present -> skip counting, re-sort;
      * ``Count_<k1>_reduced/_SUCCESS`` present -> skip the (k1, k2) pair,
        load both sides back;
      * a completed ``Count_<k>_sorted`` deletes the superseded
        ``Count_<k>`` directory (``Pipelines.java:1425-1436``).

    Then the stitch k-mer pass writes ``Stitch_kmer/Count_31_sorted``
    (``Pipelines.java:1665-1733``). ``plain=True`` counts through the
    kernels' plain torch versions (the card's reference path).

    Not ported: ``-accurate`` (mercy k-mers; the CLI refuses it) and
    ``REFLEXIV_INGEST_BUDGET_MB`` (out-of-core counting; it is not read,
    and the whole read matrix is loaded). The port runs on one device.
    """
    del seed   # reduce draws nothing at random
    from .io import load_reads_filtered

    if params.sensitive:
        raise NotImplementedError("reduce -accurate (mercy k-mers) is not "
                                  "ported")
    for k in params.klist:
        check_k(k)
    device = resolve_device(device)
    met = metrics.current()
    out = params.output_path
    _guard_reduce_signature(out, params)
    pattern = params.input_fastq or params.input_fasta
    with _lap("ingest", device):
        mat, lens = load_reads_filtered(pattern, params)
        read_width = mat.shape[1]
        mat = torch.from_numpy(mat).to(device)
        lens = torch.from_numpy(lens).to(device)

    def count_k(k, min_cov, max_cov):
        with _lap("count", device):
            return count_kmers_auto(
                mat, lens, k=k, min_cov=min_cov, max_cov=max_cov,
                front_clip=params.front_clip, end_clip=params.end_clip,
                partitions=params.partitions, device=device, plain=plain)

    def write_set(directory, triple, k):
        with _lap("write", device):
            met.add("reduce/bytes_written",
                    _write_sorted_set(directory, triple, k, device=device))

    klist = sorted(k for k in params.klist if k + 2 < read_width)
    sorted_sets = {}
    for k in klist:
        sdir = os.path.join(out, f"Count_{k}_sorted")
        cdir = os.path.join(out, f"Count_{k}")
        if has_success_marker(sdir):
            log.info("k=%d: Count_%d_sorted exists; skipping count+sort",
                     k, k)
            sorted_sets[k] = read_sorted_set(sdir, k)
            continue
        if has_success_marker(cdir):
            log.info("k=%d: Count_%d exists; skipping counting", k, k)
            keys, counts = read_count_table(cdir, k)
            keys, counts = keys.to(device), counts.to(device)
        else:
            keys, counts = count_k(
                k, params.min_kmer_coverage, params.max_kmer_coverage)
            with _lap("write", device):
                write_count_table(cdir, keys, counts, k)
        with _lap("sort", device):
            sorted_sets[k] = sort_k_records(keys, counts, k, params)
        del keys, counts
        write_set(sdir, sorted_sets[k], k)
        if os.path.isdir(cdir):
            shutil.rmtree(cdir)
    for k1, k2 in zip(klist, klist[1:]):
        rdir = os.path.join(out, f"Count_{k1}_reduced")
        if has_success_marker(rdir):
            log.info("reduce %d vs %d: Count_%d_reduced exists; skipping",
                     k1, k2, k1)
            sorted_sets[k1] = read_sorted_set(rdir, k1)
            sorted_sets[k2] = read_sorted_set(
                os.path.join(out, f"Count_{k2}_sorted"), k2)
            continue
        with _lap("pair", device):
            shorts, longs = reduce_k_pair(sorted_sets[k1], sorted_sets[k2],
                                          k1, k2, device=device)
        sorted_sets[k1] = shorts
        sorted_sets[k2] = longs
        # the adjusted longer-k set replaces its _sorted table mid-ladder
        # (Pipelines.java:257-283), written FIRST: the skip path assumes
        # the rewrite happened whenever the reduced marker exists
        write_set(os.path.join(out, f"Count_{k2}_sorted"), longs, k2)
        write_set(rdir, shorts, k1)
    last = os.path.join(out, f"Count_{klist[-1]}_reduced")
    if not has_success_marker(last):
        write_set(last, sorted_sets[klist[-1]], klist[-1])
    for k, triple in sorted_sets.items():
        met.set(f"reduce/records_k{k}", len(triple[0]))

    if params.stitch_kmer:
        # stitch k-mer pass: coverage-1 k-mers at the stitch size, sorted,
        # under Stitch_kmer/ for the stitch command
        ssize = 31
        sdir = os.path.join(out, "Stitch_kmer", f"Count_{ssize}_sorted")
        if not has_success_marker(sdir):
            keys, counts = count_k(ssize, 1, 1)
            stitch_params = dataclasses.replace(
                params, min_kmer_coverage=1, max_kmer_coverage=1_000_000)
            with _lap("sort", device):
                triple = sort_k_records(keys, counts, ssize, stitch_params)
            write_set(sdir, triple, ssize)
            met.set("reduce/records_stitch31", len(triple[0]))
            log.info("stitch k-mers: %d coverage-1 %d-mers sorted",
                     counts.numel(), ssize)

    log.info("reduction complete: %s", ", ".join(
        f"k{k}={len(v[0])}" for k, v in sorted_sets.items()))


def _write_sorted_set(directory: str, triple: Triple, k: int, *,
                      device="cpu") -> int:
    """Write ``KMERSTRING,1|left|right`` rows (the sorted/reduced format,
    ``DSBinaryFullKmerArrayToString``, LeftAndRightSorting ``:246-326``)
    + _SUCCESS, formatted on ``device``; the same bytes as
    ``dynamic._write_sorted_set``. Returns the bytes written."""
    bases, left, right = triple
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "part-00000.csv"), "wb") as fh:
        n = write_rows(fh, bases, [b",1|", left, b"|", right, b"\n"],
                       device=device)
    write_success_marker(directory)
    return n


def read_sorted_set(pattern: str, k: int) -> Triple:
    """Read a ``Count_<k>_sorted``/``_reduced`` table back
    (``dynamic.read_sorted_set``)."""
    rows, lefts, rights = [], [], []
    for part in part_files(pattern):
        opener = gzip.open if part.endswith(".gz") else open
        with opener(part, "rb") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                km, _, attr = line.partition(b",")
                _m, l, r = attr.split(b"|")
                rows.append(km)
                lefts.append(int(l))
                rights.append(int(r))
    bases = np.stack([
        encode_ascii(np.frombuffer(s, np.uint8)) for s in rows
    ]) if rows else np.zeros((0, k), np.uint8)
    return bases, np.asarray(lefts, np.int32), np.asarray(rights, np.int32)
