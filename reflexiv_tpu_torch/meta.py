"""The ``meta`` command: dynamic multi-k assembly (the assembly half of
``reflexiv_tpu.dynamic``).

Stages, each checkpointed under ``<out>/steps`` (:mod:`.checkpoint`):
  00 count + sort each k and 01 reduce the k ladder (:mod:`.dynamic`), or
     the ``Count_<k>_reduced`` tables a prior ``reduce`` left;
  02 mixed-k extension (``ReflexivDSDynamicKmerIteration``): rounds of the
     summary join on the device (:mod:`.packed_dyn`) over a host-resident
     ragged pool (:mod:`.dyn_pool`), to a fixpoint;
  03 fixing (``ReflexivDSDynamicKmerFixing``): contig ends re-enter as
     fork-filtered 31-mers and the loop runs again;
  04 read-graph reassembly of fragment-scale contigs (:mod:`.reassemble`)
     and read-consensus end extension (:mod:`.mapping`);
  05 the extend pass (fixing again over the extended contigs; skipped
     under ``REFLEXIV_SKIP_EXTEND_PASS=1``);
  06 containment dedup;
then, with ``-patch``/``-scaffold``, read-pair patching (:mod:`.patching`),
whose link table goes to ``<out>/04Patching/links.tsv``. ``-accurate``
counts each k of stage 00 through :func:`mercy.mercy_kmer_table`.

On one card the loop is the JAX package's summary-indexed form
(``REFLEXIV_INDEXED_ALWAYS=1``): one device call per round on all rows.
Its hash buckets, slab tiers and prefetch thread existed for the TPU
compiler and are not here; a bucket never split a group and kept pool
order inside it, so one call makes the same joins. Under
``REFLEXIV_INGEST_BUDGET_MB`` stage 00 counts every k it lacks in one
streaming pass over the files (:func:`count.count_kmers_from_files_multi`);
the reads are still loaded for stage 04, as in the JAX package.

``meta`` also takes a mesh (:func:`parallel.make_mesh`; the CLI meshes
over every card for ``-device cuda`` when there are several), and then
runs the JAX package's mesh path, a different algorithm: stage 00 counts
and fork-filters each k sharded (:func:`parallel.sort_k_records_sharded`,
:func:`parallel.mercy_kmer_table_sharded` under ``-accurate``; before the
ingest budget, which a mesh ignores), and stages 02, 03 and 05 run
:func:`run_dyn_extension_mesh`: dense rounds on per-shard
:class:`packed_dyn.FlatPool` pools, rows hash-routed every round, with
that loop's own stop, census, parking and overflow-retry rules, and the
dense forms of fixing. Reassembly, end extension, dedup and patching stay
on one card, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import checkpoint as ckpt
from . import metrics
from . import packed_dyn as pd
from . import parallel
from .bitpack import (MASK32, decode_to_str, encode_ascii, pack_bases,
                      revcomp_bases)
from .count import count_kmers_auto, count_kmers_from_files_multi
from .device import resolve_device, synchronize
from .dyn_pool import (DynRecords, PackedDynRecords, RaggedPool,
                       from_dyn_host, groups_to_dense, host_concat_packed,
                       host_concat_row, host_summaries, host_window,
                       limb_masks, limbs_for, next_pow2, pack_seq_matrix_np,
                       summaries_ragged, summaries_rows, to_dyn_host,
                       unpack_rows_np, unpack_seq_matrix_np)
from .dynamic import (_count_signature, read_sorted_set, reduce_k_pair,
                      sort_k_records)
from .graph import build_initial_records
from .io import has_success_marker, ingest_budget_bytes
from .mercy import mercy_kmer_table
from .packed import pack_seq_matrix, unpack_seq_matrix
from .params import Params
from .records import REPEAT_KILLED

log = logging.getLogger("reflexiv_tpu_torch")

# round caps of the two faithful fixing passes (04Fixing, 05FixingAgain)
FIXING_PASS_ROUNDS = (18, 30)


# ---------------------------------------------------------------------------
# the extension loop
# ---------------------------------------------------------------------------

def _upload(a: np.ndarray, device) -> torch.Tensor:
    """Host int32/uint32 array -> int64 tensor on ``device``; uint32 goes
    over as its int32 bits and is widened there."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device) \
            .to(torch.int64) & MASK32
    return torch.from_numpy(a).to(device)


def pdyn_round_indexed_host(pool: RaggedPool, summ, round_seed: int, *,
                            kmin: int, max_sub: int, unique_only: bool,
                            need: int, device):
    """One mixed-k round (``dynamic._pdyn_round_indexed_host``): the device
    joins the summaries, the host splices the merged rows. Short merges go
    through the vectorised dense splice, merges touching an overflow row
    (or longer than the dense width) through the per-row one. The new pool
    holds the kept rows in order, then the merged rows by forward row.
    Returns ``(pool, summ, live_n, need)``, the summaries maintained for
    the merged rows only."""
    length, subk = pool.length, pool.subk
    left, right = pool.left, pool.right
    head, tailw, h16, t16 = summ
    N = pool.n
    if N == 0:
        return pool, summ, 0, int(need)
    met = metrics.current()
    t0 = time.perf_counter()
    f_all, r_all, nl, nr = (t.cpu().numpy() for t in pd.pdyn_round_indexed(
        *(_upload(a, device) for a in (head, tailw, h16, t16, length, subk,
                                       left, right)),
        round_seed, kmin=kmin, max_sub=max_sub, unique_only=unique_only))
    t1 = time.perf_counter()
    met.add_time("meta/round_join", t1 - t0)
    SW = head.shape[1]
    gone = np.zeros(N, bool)
    gone[f_all] = True
    gone[r_all] = True
    keep_idx = np.nonzero(~gone)[0]

    over_mask = np.zeros(N, bool)
    if pool.over:
        over_mask[np.fromiter(pool.over, int, len(pool.over))] = True
    tot_all = length[r_all].astype(np.int64) + length[f_all] - subk[r_all]
    fast = (~over_mask[r_all]) & (~over_mask[f_all]) & (
        tot_all <= pool.W_DENSE * 16)
    rf, ff = r_all[fast], f_all[fast]
    rs, fs = r_all[~fast], f_all[~fast]

    if len(rf):
        out_limbs = limbs_for(int(tot_all[fast].max()))
        mseq, mlen = host_concat_packed(
            pool.dense[rf], length[rf], pool.dense[ff], length[ff],
            subk[rf], out_limbs)
        mh, mt, mh16, mt16 = host_summaries((mseq, mlen, subk[ff]), max_sub)
    else:
        out_limbs = 0
        mlen = np.zeros(0, np.int32)
        mh = mt = np.zeros((0, SW), np.uint32)
        mh16 = mt16 = np.zeros(0, np.uint32)

    slow_rows = []
    slow_lens = np.empty(len(rs), np.int32)
    for j, (ri, fi) in enumerate(zip(rs, fs)):
        arr, tot = host_concat_row(
            pool.row_seq(int(ri)), int(length[ri]),
            pool.row_seq(int(fi)), int(length[fi]), int(subk[ri]))
        slow_rows.append(arr)
        slow_lens[j] = tot
    if len(rs):
        sh, st, sh16, st16 = summaries_rows(slow_rows, slow_lens, subk[fs],
                                            max_sub)
    else:
        sh = st = np.zeros((0, SW), np.uint32)
        sh16 = st16 = np.zeros(0, np.uint32)

    # the new pool: [kept rows, fast merged, slow merged]
    n_keep, n_fast = len(keep_idx), len(rf)
    n_new = n_keep + n_fast + len(rs)
    base = pool.select(keep_idx)
    wd_new = min(pool.W_DENSE, max(base.dense.shape[1], out_limbs, 1))
    dense_new = np.zeros((n_new, wd_new), np.uint32)
    dense_new[:n_keep, :base.dense.shape[1]] = base.dense
    if n_fast:
        dense_new[n_keep:n_keep + n_fast, :out_limbs] = mseq
    over_new = dict(base.over)
    for j, arr in enumerate(slow_rows):
        over_new[n_keep + n_fast + j] = arr
    new_pool = RaggedPool(
        dense_new,
        np.concatenate([length[keep_idx], mlen, slow_lens]).astype(np.int32),
        np.concatenate([subk[keep_idx], subk[ff], subk[fs]]).astype(np.int32),
        np.concatenate([left[keep_idx], nl[fast], nl[~fast]]).astype(np.int32),
        np.concatenate([right[keep_idx], nr[fast], nr[~fast]])
        .astype(np.int32),
        over_new)
    nsum = (np.concatenate([head[keep_idx], mh, sh]),
            np.concatenate([tailw[keep_idx], mt, st]),
            np.concatenate([h16[keep_idx], mh16, sh16]),
            np.concatenate([t16[keep_idx], mt16, st16]))
    nlen = new_pool.length
    if n_new >= 2:
        top2 = np.partition(nlen, n_new - 2)[-2:]
        need_out = int(top2[0]) + int(top2[1])
    else:
        need_out = int(nlen.max()) if n_new else int(need)
    met.add_time("meta/round_splice", time.perf_counter() - t1)
    return new_pool, nsum, n_new, need_out


def run_dyn_extension(recs, params: Params, *, kmin: int, seed: int = 0,
                      unique_only: bool = False,
                      max_rounds: Optional[int] = None,
                      ckpt_dir: Optional[str] = None, device) -> List[tuple]:
    """Mixed-k rounds to a fixpoint (``dynamic.run_dyn_extension``, its
    indexed branch; cf. ``Pipelines.java:856-952``). ``recs`` is a
    width-class group list or a host pool (byte or packed). Returns the
    live rows as width-class groups, then the parked groups.

    Stop rules: after ``min_iterations`` once the live count has been
    stable for 12 rounds, or at ``max_rounds``. Every 4th round (``it % 4
    == 3``) and on any stable round the census parks finished rows (more
    than max(32, n / 16) of them, or all). With ``ckpt_dir`` the loop state
    is saved every ``REFLEXIV_CKPT_EVERY_S`` seconds (default 300) and a
    later call resumes from it."""
    max_rounds = max_rounds or params.max_iterations
    ckpt_every = float(os.environ.get("REFLEXIV_CKPT_EVERY_S", "300"))
    last_ckpt = time.time()
    met = metrics.current()

    state0 = ckpt.load_loop_state(ckpt_dir) if ckpt_dir else None
    if state0 is not None:
        recs, parked, st = state0
        max_sub, it0 = st["max_sub"], st["it"] + 1
        stable, prev, need = st["stable"], st["prev"], st["need"]
        log.info("extension loop: resuming at round %d (%d live rows)",
                 it0, prev)
    else:
        parked, it0, stable = [], 1, 0
        if isinstance(recs, list):
            max_sub = max([int(g[2].max()) for g in recs if len(g[2])]
                          or [1])
            prev = sum(len(g[1]) for g in recs)
            need = 2 * max([int(g[1].max()) for g in recs if len(g[1])]
                           or [16])
        else:
            live = recs.live
            max_sub = int(np.where(live, recs.subk, 1).max())
            prev = int(live.sum())
            need = 2 * int(np.where(live, recs.length, 0).max())
    if isinstance(recs, list):
        rp = RaggedPool.from_groups(recs)
    else:
        p = recs if np.dtype(recs.seq.dtype) == np.uint32 \
            else from_dyn_host(recs)
        idx = np.nonzero(p.live)[0]
        rp = RaggedPool.from_dense(tuple(a[idx] for a in p[:5]))
    del recs
    summ = summaries_ragged(rp, max_sub)

    for it in range(it0, max_rounds + 1):
        rp, summ, n, need = pdyn_round_indexed_host(
            rp, summ, seed + it, kmin=kmin, max_sub=max_sub,
            unique_only=unique_only, need=need, device=device)
        met.add("meta/rounds")
        if n == prev:
            stable += 1
        else:
            stable, prev = 0, n
        log.info("extension round %d: %d live rows", it, n)
        if n and (it % 4 == 3 or stable >= 1):
            t0 = time.perf_counter()
            fin = pd.finished_mask(
                *(_upload(a, device) for a in (summ[0], summ[1], rp.subk)),
                max_sub).cpu().numpy()
            nf = int(fin.sum())
            if nf == n or nf > max(32, n // 16):
                parked.extend(rp.select(np.nonzero(fin)[0]).to_groups())
                keep = np.nonzero(~fin)[0]
                rp = rp.select(keep)
                summ = tuple(a[keep] for a in summ)
                prev = n = n - nf
                log.info("census: parked %d, %d live", nf, n)
            met.add_time("meta/round_census", time.perf_counter() - t0)
        if ckpt_dir and time.time() - last_ckpt >= ckpt_every:
            ckpt.save_loop_state(ckpt_dir, rp.to_groups(), parked, {
                "it": it, "stable": stable, "prev": prev, "need": need,
                "max_sub": max_sub})
            last_ckpt = time.time()
        if not n:
            break   # every row parked: no later round can change anything
        if it >= params.min_iterations and stable >= 12:
            break
    # the in-loop checkpoints stay until the caller has saved the result
    return rp.to_groups() + parked


# ---------------------------------------------------------------------------
# the extension loop on a mesh
# ---------------------------------------------------------------------------

def as_flat(pool) -> pd.FlatPool:
    """A stage pool (flat, byte or packed host pool, or width-class
    groups) as a host :class:`packed_dyn.FlatPool` of its live rows, in
    order."""
    if isinstance(pool, pd.FlatPool):
        return pool.to("cpu")
    if isinstance(pool, list):
        return pd.from_groups(pool)
    p = pool if np.dtype(pool.seq.dtype) == np.uint32 \
        else from_dyn_host(pool)
    idx = np.nonzero(np.asarray(p.live))[0]
    return pd.from_dense(np.asarray(p.seq)[idx],
                         *(np.asarray(a)[idx] for a in p[1:5]))


def _mesh_capacity(live: int, n_dev: int) -> int:
    """The JAX mesh loop's pool rows for ``live`` rows: twice the next
    power of two, at least 64 a shard, a multiple of the shard count."""
    cap = max(next_pow2(max(live, 1)) * 2, 64 * n_dev)
    return -(-cap // n_dev) * n_dev


def run_dyn_extension_mesh(pool, params: Params, *, kmin: int,
                           mesh: "parallel.Mesh", seed: int = 0,
                           unique_only: bool = False,
                           max_rounds: Optional[int] = None,
                           ckpt_dir: Optional[str] = None) -> pd.FlatPool:
    """Mixed-k rounds to a fixpoint on a mesh (``dynamic
    .run_dyn_extension``'s mesh branch with ``return_packed``). The pool
    is laid out as the JAX package's ``_pad_pdyn`` lays it, on ``cap``
    rows; every round is :func:`parallel.pdyn_extension_round_sharded`.
    A round the JAX loop would overflow is dropped and retried on a pool
    of twice the rows, the round not advancing (log line "dyn round N
    overflowed"). The census (the exact one, mesh-wide) runs when the
    live count has been stable for a multiple of 3 rounds and stops the
    loop when every row is finished; the loop also stops after
    ``min_iterations`` once stable for 12 rounds, or at ``max_rounds``.
    Every 8th round it parks the finished rows as one batch when there
    are more than ``max(32, cap / 8)`` and re-lays the rest. With
    ``ckpt_dir`` the loop state, ``cap`` included, is saved every
    ``REFLEXIV_CKPT_EVERY_S`` seconds (default 300) in the JAX package's
    format, and a later call resumes from it. Returns a host pool: the
    live rows in shard order, then the parked batches."""
    max_rounds = max_rounds or params.max_iterations
    ckpt_every = float(os.environ.get("REFLEXIV_CKPT_EVERY_S", "300"))
    last_ckpt = time.time()
    met = metrics.current()
    n_dev = mesh.size

    state0 = ckpt.load_loop_state(ckpt_dir, flat=True) if ckpt_dir else None
    if state0 is not None:
        pool, parked, st = state0
        max_sub, it = st["max_sub"], st["it"] + 1
        stable, prev, need = st["stable"], st["prev"], st["need"]
        cap = st.get("cap") or _mesh_capacity(prev, n_dev)
        log.info("extension loop: resuming at round %d (%d live rows)",
                 it, prev)
    else:
        pool = as_flat(pool)
        parked, it, stable = [], 1, 0
        max_sub = int(pool.subk.max()) if pool.n else 1
        prev = pool.n
        need = 2 * int(pool.length.max()) if pool.n else 0
        cap = _mesh_capacity(prev, n_dev)
    cap = -(-cap // n_dev) * n_dev
    shards = parallel.pad_pdyn([pool], cap, mesh)
    del pool

    def census():
        t0 = time.perf_counter()
        fin = parallel.finished_mask_pdyn_sharded(shards, max_sub, mesh)
        met.add_time("meta/round_census", time.perf_counter() - t0)
        return fin, sum(int(f.sum()) for f in fin)

    while it <= max_rounds:
        t0 = time.perf_counter()
        nxt = parallel.pdyn_extension_round_sharded(
            shards, seed + it, kmin=kmin, max_sub=max_sub, mesh=mesh,
            cap=cap, unique_only=unique_only)
        met.add_time("meta/round_join", time.perf_counter() - t0)
        if nxt is None:
            cap *= 2
            log.info("dyn round %d overflowed; repadding to %d", it, cap)
            met.add("meta/round_retries")
            shards = parallel.pad_pdyn(shards, cap, mesh)
            continue
        shards = nxt
        met.add("meta/rounds")
        n = sum(p.n for p in shards)
        need = 2 * max([int(p.length.max()) for p in shards if p.n] or [0])
        if n == prev:
            stable += 1
        else:
            stable, prev = 0, n
        log.info("extension round %d: %d live rows", it, n)
        if stable >= 3 and stable % 3 == 0 and census()[1] == n:
            break
        if it >= params.min_iterations and stable >= 12:
            break
        if it % 8 == 0 and it >= 8:
            fin, n_fin = census()
            if n_fin > max(32, cap // 8):
                batch: List[pd.FlatPool] = []
                shards = [pd.park_finished_pdyn(p, f, batch)
                          for p, f in zip(shards, fin)]
                parked.append(pd.cat(batch, "cpu"))
                prev = n - n_fin
                cap = _mesh_capacity(prev, n_dev)
                shards = parallel.pad_pdyn(shards, cap, mesh)
                log.info("census: parked %d, %d live", n_fin, prev)
        if ckpt_dir and time.time() - last_ckpt >= ckpt_every:
            ckpt.save_loop_state(ckpt_dir, pd.cat(shards, "cpu"), parked, {
                "it": it, "stable": stable, "prev": prev, "need": need,
                "max_sub": max_sub, "cap": cap})
            last_ckpt = time.time()
        it += 1
    # the in-loop checkpoints stay until the caller has saved the result
    return pd.merge_parked_pdyn(pd.cat(shards, "cpu"), parked)


# ---------------------------------------------------------------------------
# fixing
# ---------------------------------------------------------------------------

def fixing_split_groups(groups, kmax: int, kfix: int = 31):
    """The 04Fixing split (``DSExtractFixingKmerFromContigEnds``,
    ``ReflexivDSDynamicKmerFixing.java:1190-1253``; ``dynamic
    ._fixing_split_groups``) over width-class groups. A row of at least
    ``2 * kmax`` bases gives ``w = kmax - kfix + 1`` kfix-mers sliding in
    from each end and its interior cut by ``w`` on both sides, whose
    blocked ends become blocked at ``3 + kmax``; shorter rows pass through.
    Returns ``(end_windows (M, kfix) uint8, part groups)``."""
    w = kmax - kfix + 1
    win = w + kfix - 1
    ends, parts = [], []
    for seq, length, subk, left, right in groups:
        if not len(length):
            continue
        big = length >= 2 * kmax
        sidx = np.nonzero(~big)[0]
        if len(sidx):
            parts.append((seq[sidx], length[sidx], subk[sidx], left[sidx],
                          right[sidx]))
        bidx = np.nonzero(big)[0]
        if not len(bidx):
            continue
        bseq, blen = seq[bidx], length[bidx].astype(np.int64)
        headb = unpack_rows_np(bseq, min(win, bseq.shape[1] * 16))
        tailb = unpack_rows_np(
            host_window(bseq, np.maximum(blen - win, 0), win), win)
        for block in (headb, tailb):
            sw = np.lib.stride_tricks.sliding_window_view(
                block, kfix, axis=1)[:, :w]
            ends.append(sw.reshape(-1, kfix))
        int_len = (blen - 2 * w).astype(np.int32)
        Wi = limbs_for(int(int_len.max()))
        int_seq = host_window(bseq, np.full(len(bidx), w, np.int64),
                              Wi * 16) & limb_masks(int_len, Wi)
        bl, br = left[bidx], right[bidx]
        parts.append((
            int_seq, int_len, np.full(len(bidx), kfix - 1, np.int32),
            np.where(bl >= 0, 3 + kmax, bl).astype(np.int32),
            np.where(br >= 0, 3 + kmax, br).astype(np.int32)))
    end_windows = (np.concatenate(ends, axis=0) if ends
                   else np.zeros((0, kfix), np.uint8))
    return end_windows, parts


def decode_groups_to_raw(groups, params: Params):
    """(contig, left, right) of every group row that is not repeat-killed
    and at least ``min_contig`` long (``dynamic._decode_groups_to_raw``)."""
    raw = []
    for seq, length, _subk, left, right in groups:
        keep = ~((left <= REPEAT_KILLED) & (right <= REPEAT_KILLED))
        keep &= length >= params.min_contig
        idx = np.nonzero(keep)[0]
        if not len(idx):
            continue
        bases = unpack_rows_np(seq[idx], int(length[idx].max()))
        for r, i in enumerate(idx):
            raw.append((decode_to_str(bases[r, :length[i]]), int(left[i]),
                        int(right[i])))
    return raw


def _decode_pool_to_raw(pool: DynRecords, params: Params):
    """The same over a byte pool's live rows, in row order."""
    raw = []
    for i in np.nonzero(pool.live)[0]:
        l, r, n = int(pool.left[i]), int(pool.right[i]), int(pool.length[i])
        if (l <= REPEAT_KILLED and r <= REPEAT_KILLED) \
                or n < params.min_contig:
            continue
        raw.append((decode_to_str(pool.seq[i, :n]), l, r))
    return raw


def groups_from_contig_rows(rows):
    """Width-class packed groups (power-of-two base classes of at least 16)
    from ``(codes, subk, left, right)`` rows (``dynamic
    ._groups_from_contig_rows``)."""
    by_cls: dict = {}
    for row in rows:
        by_cls.setdefault(next_pow2(max(len(row[0]), 16)), []).append(row)
    groups = []
    for cls_bases, members in sorted(by_cls.items()):
        n = len(members)
        bases = np.zeros((n, cls_bases), np.uint8)
        cols = [np.empty(n, np.int32) for _ in range(4)]
        for i, (codes, sk, l, r) in enumerate(members):
            bases[i, :len(codes)] = codes
            cols[0][i], cols[1][i], cols[2][i], cols[3][i] = \
                len(codes), sk, l, r
        groups.append((pack_seq_matrix_np(bases), *cols))
    return groups


def dyn_pool_from_rows(rows) -> DynRecords:
    """``(codes, subk, left, right)`` rows -> a byte pool of power-of-two
    shape (``dynamic._dyn_pool_from_rows``)."""
    cap = max(next_pow2(max(len(rows), 1)), 16)
    L = next_pow2(max([len(c) for c, _, _, _ in rows] + [2]))
    seq = np.zeros((cap, L), np.uint8)
    length = np.zeros(cap, np.int32)
    subk = np.ones(cap, np.int32)
    left = np.zeros(cap, np.int32)
    right = np.zeros(cap, np.int32)
    live = np.zeros(cap, bool)
    for j, (codes, sk, l, r) in enumerate(rows):
        seq[j, :len(codes)] = codes
        length[j], subk[j], left[j], right[j] = len(codes), sk, l, r
        live[j] = True
    return DynRecords(seq, length, subk, left, right, live)


def _end_kmer_rows(end_windows: torch.Tensor, params: Params, kfix: int):
    """The fixing pass's end k-mer rows ``(limbs, length, subk, left,
    right)``: the end windows' distinct canonical kfix-mers, counts
    flattened to 1 (the reference's marker assignment discards them),
    fork-filtered both ways, in the graph's row order."""
    canon = torch.minimum(pack_bases(end_windows, kfix),
                          pack_bases(revcomp_bases(end_windows), kfix))
    uniq = torch.unique(canon)
    rec = build_initial_records(
        uniq, torch.ones(uniq.numel(), dtype=torch.int32,
                         device=uniq.device),
        k=kfix, min_error=params.min_error_for_k(kfix))
    live = rec.live
    n = int(live.sum())
    full = torch.full((n,), kfix, dtype=torch.int32, device=uniq.device)
    return (pack_seq_matrix(rec.seq[live][:, :kfix].to(torch.uint8)),
            full, full - 1, rec.left[live], rec.right[live])


def fixing_rounds_faithful(pool, params: Params, *, kmax: int,
                           kfix: int = 31, seed: int = 1000,
                           ckpt_ns: Optional[str] = None, device=None,
                           mesh: Optional["parallel.Mesh"] = None):
    """04Fixing + 05FixingAgain (``ReflexivDSDynamicKmerFixing.java
    :125-259``, ``...RoundTwo.java:138-263``; ``dynamic
    .fixing_rounds_faithful``). Each pass splits every contig's end
    regions into kfix-mers, deduplicates them, fork-filters them both ways
    (counts flattened to 1, as the reference's marker assignment does) and
    runs bounded fixed-k rounds over the end k-mers and the interiors, so
    ends overlapping at any offset >= kfix re-join. Without ``mesh`` the
    pool is width-class groups (:func:`fixing_split_groups`,
    :func:`run_dyn_extension` on ``device``); with one it is the dense
    form, a flat pool (:func:`fixing_split_flat`,
    :func:`run_dyn_extension_mesh`). ``ckpt_ns`` saves each finished
    pass."""
    if mesh is not None:
        pool = as_flat(pool)
        device = mesh.devices[0]
    for pass_i, n_rounds in enumerate(FIXING_PASS_ROUNDS):
        if ckpt_ns:
            done_dir = f"{ckpt_ns}_p{pass_i}_done"
            if has_success_marker(done_dir):
                pool = ckpt.load_records(os.path.dirname(done_dir),
                                         os.path.basename(done_dir),
                                         flat=mesh is not None)
                continue
        if mesh is None:
            end_windows, parts = fixing_split_groups(pool, kmax, kfix)
            end_windows = torch.from_numpy(
                np.ascontiguousarray(end_windows)).to(device)
        else:
            end_windows, *parts = fixing_split_flat(pool.to(device), kmax,
                                                    kfix)
        if not len(end_windows):
            return pool
        ends = _end_kmer_rows(end_windows, params, kfix)
        fix_params = dataclasses.replace(
            params, min_iterations=min(params.min_iterations, n_rounds))
        loop_args = dict(kmin=kfix, seed=seed + 500 * pass_i,
                         max_rounds=n_rounds,
                         ckpt_dir=f"{ckpt_ns}_p{pass_i}" if ckpt_ns else None)
        if mesh is None:
            limbs, *cols = (t.cpu().numpy() for t in ends)
            pool = run_dyn_extension(
                [(limbs.astype(np.uint32), *cols)] + parts, fix_params,
                device=device, **loop_args)
        else:
            pool = run_dyn_extension_mesh(
                pd.cat([pd.from_dense(*ends), *parts], "cpu"), fix_params,
                mesh=mesh, **loop_args)
        if ckpt_ns:
            ckpt.save_records(os.path.dirname(done_dir),
                              os.path.basename(done_dir), pool)
    return pool


def fixing_rounds(pool, params: Params, *, kfix: int = 31, seed: int = 1000,
                  ckpt_ns: Optional[str] = None, device) -> DynRecords:
    """Contig-end rejoin on unique exact (kfix-1)-base overlaps
    (``dynamic.fixing_rounds``, for k ladders under 32): every live row of
    at least kfix bases gets ``subk = kfix - 1`` and free ends, and the
    loop joins only groups of one forward and one reflected row, for at
    most 48 rounds. Returns a byte pool: the loop's live rows, then its
    parked rows."""
    sub = np.minimum(np.int32(kfix - 1), pool.length - 1)
    eligible = pool.live & (pool.length >= kfix)
    pool = pool._replace(
        subk=np.where(eligible, sub, pool.subk).astype(np.int32),
        left=np.where(eligible, -1, pool.left).astype(np.int32),
        right=np.where(eligible, -1, pool.right).astype(np.int32))
    groups = run_dyn_extension(
        pool, params, kmin=kfix, seed=seed, unique_only=True, max_rounds=48,
        ckpt_dir=f"{ckpt_ns}_fast" if ckpt_ns else None, device=device)
    dense = groups_to_dense(groups)
    return to_dyn_host(PackedDynRecords(*dense, np.ones(len(dense[1]),
                                                        bool)))


def fixing_split_flat(pool: pd.FlatPool, kmax: int, kfix: int = 31):
    """The 04Fixing split of a dense pool (``dynamic._fixing_split_arrays``)
    over a flat pool on its device: rows of at least ``2 * kmax`` bases
    give ``w = kmax - kfix + 1`` kfix-mers from each end and their
    interior cut by ``w`` on both sides (``subk = kfix - 1``, blocked
    ends blocked at ``3 + kmax``), in pool order; shorter rows pass
    through. Returns ``(end windows (M, kfix) uint8, interiors,
    smalls)``."""
    w = kmax - kfix + 1
    win = w + kfix - 1
    big = pool.length >= 2 * kmax
    bidx = torch.nonzero(big).squeeze(1)
    smalls = pd.take(pool, torch.nonzero(~big).squeeze(1))
    blen = pool.length[bidx]
    ends = []
    for start in (torch.zeros_like(blen), (blen - win).clamp(min=0)):
        block = unpack_seq_matrix(pd.pool_window(pool, start, win, bidx), win)
        ends.append(block.unfold(1, kfix, 1)[:, :w].reshape(-1, kfix))
    limbs, int_len = pd.flat_concat(
        pool, bidx, torch.zeros_like(blen), bidx, blen - w,
        torch.full_like(blen, w))
    bl, br = pool.left[bidx], pool.right[bidx]
    interiors = pd.FlatPool(
        limbs, int_len, torch.full_like(blen, kfix - 1),
        torch.where(bl >= 0, 3 + kmax, bl).to(torch.int32),
        torch.where(br >= 0, 3 + kmax, br).to(torch.int32))
    return torch.cat(ends), interiors, smalls


def fixing_rounds_mesh(pool, params: Params, *, mesh: "parallel.Mesh",
                       kfix: int = 31, seed: int = 1000,
                       ckpt_ns: Optional[str] = None) -> pd.FlatPool:
    """:func:`fixing_rounds` on a mesh (``dynamic.fixing_rounds`` with a
    mesh): the same eligible rows and attrs, then
    :func:`run_dyn_extension_mesh` with unique joins only, at most 48
    rounds."""
    pool = as_flat(pool)
    eligible = pool.length >= kfix
    pool = pool._replace(
        subk=torch.where(eligible, (pool.length - 1).clamp(max=kfix - 1),
                         pool.subk).to(torch.int32),
        left=torch.where(eligible, -1, pool.left).to(torch.int32),
        right=torch.where(eligible, -1, pool.right).to(torch.int32))
    return run_dyn_extension_mesh(
        pool, params, kmin=kfix, seed=seed, unique_only=True, max_rounds=48,
        ckpt_dir=f"{ckpt_ns}_fast" if ckpt_ns else None, mesh=mesh)


def decode_flat_to_raw(pool: pd.FlatPool, params: Params):
    """(contig, left, right) of every row of a flat pool that is not
    repeat-killed and at least ``min_contig`` long, in row order."""
    pool = pool.to("cpu")
    keep = ~((pool.left <= REPEAT_KILLED) & (pool.right <= REPEAT_KILLED))
    keep &= pool.length >= params.min_contig
    part = pd.take(pool, torch.nonzero(keep).squeeze(1))
    limbs = part.limbs.numpy().astype(np.uint32)
    off, nl = (t.numpy() for t in pd.row_offsets(part.length))
    return [(decode_to_str(unpack_rows_np(limbs[None, o:o + w], int(n))[0]),
             int(l), int(r))
            for o, w, n, l, r in zip(off, nl, part.length.tolist(),
                                     part.left.tolist(), part.right.tolist())]


def flat_from_rows(rows) -> pd.FlatPool:
    """``(codes, subk, left, right)`` rows -> a host flat pool in order
    (``dynamic._dyn_pool_from_rows``' live rows)."""
    limbs = [pack_seq_matrix_np(np.asarray(c, np.uint8)[None])[0]
             [:limbs_for(len(c))] for c, _, _, _ in rows]
    cols = [torch.tensor([row[i] for row in rows], dtype=torch.int32)
            for i in (1, 2, 3)]
    return pd.FlatPool(
        torch.from_numpy(np.concatenate(limbs + [np.zeros(0, np.uint32)])
                         .astype(np.int64)),
        torch.tensor([len(c) for c, _, _, _ in rows], dtype=torch.int32),
        *cols)


# ---------------------------------------------------------------------------
# dedup
# ---------------------------------------------------------------------------

def dedup_contigs_python(contigs: List[str], seed_k: int = 31) -> List[str]:
    """Drop contigs contained in a longer contig on either strand
    (``ReflexivDSDynamicKmerDedup``, ``:138-340``; ``dynamic
    .dedup_contigs``' Python form). Candidates come from k-mer seeds kept
    every 16 bases of each kept contig; 16 consecutive probes of a query
    hit one for any true containment."""
    from .contigs import revcomp_str

    out: List[str] = []
    stride = 16
    seed_index: dict = {}
    for s in sorted(set(contigs), key=len, reverse=True):
        rc = revcomp_str(s)
        if len(s) < seed_k + stride - 1:
            if not any(s in t or rc in t for t in out):
                out.append(s)
            continue
        cands = set()
        for q in (s, rc):
            for i in range(stride):
                cands.update(seed_index.get(q[i:i + seed_k], ()))
        if not any(s in out[c] or rc in out[c] for c in cands):
            cid = len(out)
            out.append(s)
            for i in range(0, len(s) - seed_k + 1, stride):
                seed_index.setdefault(s[i:i + seed_k], []).append(cid)
    return out


def dedup_contigs(contigs: List[str], seed_k: int = 31) -> List[str]:
    """:func:`dedup_contigs_python` through the native library's
    ``rfx_dedup`` when it loads (``dynamic.dedup_contigs``)."""
    from .native import dedup_contigs_native

    out = dedup_contigs_native(contigs, seed_k=seed_k)
    return out if out is not None else dedup_contigs_python(contigs, seed_k)


# ---------------------------------------------------------------------------
# the pipeline stages
# ---------------------------------------------------------------------------

def records_from_sorted(sets: Sequence[Tuple]) -> PackedDynRecords:
    """Per-k (bases, left, right, k) sets -> one all-live packed host pool
    (``dynamic.records_from_sorted``): the same rows, each k packed on its
    own, so the byte matrix of every row at the widest width never exists.
    Rows are ``limbs_for(next_pow2(2 * kmax))`` limbs wide, as the JAX
    pool's are once packed."""
    total = sum(len(b) for b, _, _, _ in sets)
    kmax = max(k for _, _, _, k in sets)
    seq = np.zeros((total, limbs_for(next_pow2(2 * kmax))), np.uint32)
    cols = [np.empty(total, np.int32) for _ in range(4)]
    at = 0
    for bases, l, r, k in sets:
        n = len(bases)
        packed = pack_seq_matrix_np(np.asarray(bases, np.uint8))
        seq[at:at + n, :packed.shape[1]] = packed
        for c, v in zip(cols, (k, k - 1, l, r)):
            c[at:at + n] = v
        at += n
    return PackedDynRecords(seq, *cols, np.ones(total, bool))


def _pool_to_sets(pool, klist):
    """Per-k (bases, left, right) of a stage 00/01 pool: a row's k is its
    length there."""
    packed = np.dtype(pool.seq.dtype) == np.uint32
    sets = {}
    for k in klist:
        m = np.asarray(pool.live) & (pool.length == k)
        sets[k] = (unpack_seq_matrix_np(pool.seq[m, :limbs_for(k)], k)
                   if packed else pool.seq[m, :k], pool.left[m],
                   pool.right[m])
    return sets


def _guard_meta_signature(workdir: str, params: Params) -> None:
    """Discard the checkpoints of a run under another klist or coverage.
    As in the JAX package, ``sensitive`` is not in the signature, so
    ``-accurate`` resumes the checkpoints of a run without it."""
    sig = {"klist": sorted(params.klist),
           "min_cov": params.min_kmer_coverage,
           "min_error": params.min_error_coverage}
    sig_path = os.path.join(workdir, "params.json")
    if os.path.exists(sig_path):
        with open(sig_path) as fh:
            if json.load(fh) != sig:
                log.info("meta params changed; discarding stale checkpoints")
                ckpt.clear_from(workdir, ckpt.META_STAGES[0])
    os.makedirs(workdir, exist_ok=True)
    with open(sig_path, "w") as fh:
        json.dump(sig, fh)


def _reduced_tables(params: Params, klist):
    """The ``Count_<k>_reduced`` sets a prior ``reduce`` left in the output
    directory under the same parameters, or None."""
    out = params.output_path
    if not out:
        return None
    sig_path = os.path.join(out, "reduce_params.json")
    if not os.path.exists(sig_path):
        return None
    with open(sig_path) as fh:
        if json.load(fh) != _count_signature(params):
            log.info("meta: Count_*_reduced present but reduce params "
                     "differ; recounting")
            return None
    rdirs = {k: os.path.join(out, f"Count_{k}_reduced") for k in klist}
    if not all(has_success_marker(d) for d in rdirs.values()):
        return None
    log.info("meta: consuming Count_*_reduced from a prior reduce run; "
             "skipping count+sort+reduce")
    return {k: read_sorted_set(d, k) for k, d in rdirs.items()}


def assemble_dynamic(bases, lengths, params: Params, *, seed: int = 0,
                     workdir: Optional[str] = None, device,
                     plain: bool = False,
                     mesh: Optional["parallel.Mesh"] = None
                     ) -> List[Tuple[str, str]]:
    """Full dynamic multi-k assembly from a read code matrix (numpy or
    tensors; ``dynamic.assemble_dynamic``). With ``workdir`` every stage
    checkpoints and the call resumes from the newest completed stage.
    ``plain=True`` counts through the kernels' plain torch versions. With
    ``mesh``, stage 00 counts on the mesh and stages 02, 03 and 05 run the
    mesh loop (the module docstring); the other stages run on
    ``device``."""
    device = resolve_device(device)
    met = metrics.current()
    if workdir:
        _guard_meta_signature(workdir, params)
    resume = ckpt.latest_stage(workdir) if workdir else None
    if resume:
        log.info("resuming meta pipeline from stage %s", resume)
    max_read = int(lengths.max()) if len(lengths) else 0
    klist = [k for k in sorted(params.klist) if k + 2 < max_read]
    if not klist:
        raise ValueError(f"no usable k in klist for read length {max_read}")
    kmin, kmax = klist[0], klist[-1]
    stages = ckpt.META_STAGES
    resume_idx = stages.index(resume) if resume else -1
    reads = []

    def on_device():
        """The read matrix on the device, uploaded once when first used."""
        if not reads:
            reads.extend(torch.as_tensor(x).to(device)
                         for x in (bases, lengths))
        return reads

    devices = {device, *(mesh.devices if mesh is not None else ())}
    cards = [d for d in devices if d.type == "cuda"]

    def lap(name):
        for dev in devices:
            synchronize(dev)
        met.lap(name)
        if cards:
            # the stage's own peak on any card; the counters restart for
            # the next stage, and meta/peak_bytes keeps the run's highest
            peak = max(torch.cuda.max_memory_allocated(d) for d in cards)
            met.set(f"{name}.peak_bytes", peak)
            met.set("meta/peak_bytes",
                    max(peak, met.counts.get("meta/peak_bytes", 0)))
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)

    pool = sorted_sets = None
    if 0 <= resume_idx < 4:
        # the mesh stages' pools come back flat: a megabase row never
        # widens every row of a dense matrix
        pool = ckpt.load_records(workdir, stages[resume_idx],
                                 flat=mesh is not None and resume_idx >= 2)
    if resume_idx < 0:
        t0 = time.perf_counter()
        pre = _reduced_tables(params, klist)
        if pre is not None:
            pool = records_from_sorted(
                [(b, l, r, k) for k, (b, l, r) in pre.items()])
            del pre
            if workdir:
                ckpt.save_records(workdir, "01reduced", pool)
            resume_idx = 1
            met.add_time("meta/read_reduced", time.perf_counter() - t0)
    met.lap_start()

    if resume_idx < 0:
        sorted_sets = {}
        if workdir:
            for k in klist:
                if ckpt.has_kset(workdir, f"00partial/k{k}"):
                    sorted_sets[k] = ckpt.load_kset(workdir,
                                                    f"00partial/k{k}")
        missing = [k for k in klist if k not in sorted_sets]
        pattern = params.input_fastq or params.input_fasta
        budget = ingest_budget_bytes()
        streamed = None
        if budget and pattern and missing and not params.sensitive \
                and mesh is None:
            # one pass over the files counts every k not checkpointed
            streamed = count_kmers_from_files_multi(
                pattern, missing, min_cov=params.min_kmer_coverage,
                max_cov=params.max_kmer_coverage,
                front_clip=params.front_clip, end_clip=params.end_clip,
                params=params, budget_bytes=budget, device=device,
                plain=plain)
        for k in missing:
            if mesh is not None and not params.sensitive:
                sorted_sets[k] = parallel.sort_k_records_sharded(
                    *on_device(), k, params, mesh=mesh, plain=plain)
            else:
                if streamed is not None:
                    keys, counts = streamed.pop(k)
                elif params.sensitive and mesh is not None:
                    keys, counts = parallel.mercy_kmer_table_sharded(
                        *on_device(), k=k, min_cov=params.min_kmer_coverage,
                        max_cov=params.max_kmer_coverage, mesh=mesh,
                        plain=plain)
                    keys, counts = keys.to(device), counts.to(device)
                elif params.sensitive:
                    # mercy k-mers enter the ladder per k
                    # (Pipelines.java:1388-1391)
                    keys, counts = mercy_kmer_table(
                        *on_device(), k=k, min_cov=params.min_kmer_coverage,
                        max_cov=params.max_kmer_coverage, device=device,
                        plain=plain)
                else:
                    mat, lens = on_device()
                    keys, counts = count_kmers_auto(
                        mat, lens, k=k, min_cov=params.min_kmer_coverage,
                        max_cov=params.max_kmer_coverage,
                        front_clip=params.front_clip,
                        end_clip=params.end_clip,
                        partitions=params.partitions, device=device,
                        plain=plain)
                sorted_sets[k] = sort_k_records(keys, counts, k, params)
                del keys, counts
            log.info("k=%d: %d sorted records", k, len(sorted_sets[k][0]))
            if workdir:
                ckpt.save_kset(workdir, f"00partial/k{k}", sorted_sets[k], k)
        # the sets in the order they arrived, restored ones first
        pool = records_from_sorted(
            [(*v, k) for k, v in sorted_sets.items()])
        if workdir:
            ckpt.save_records(workdir, "00sorted", pool)
            ckpt.clear_partial(workdir, "00partial")
        lap("meta/00count_sort")

    if resume_idx < 1:
        # the sets stage 00 just made, in the klist order of the pool's
        # rows, are what ``_pool_to_sets`` would read back from it
        sorted_sets = ({k: sorted_sets[k] for k in klist} if sorted_sets
                       else _pool_to_sets(pool, klist))
        for i, (k1, k2) in enumerate(zip(klist, klist[1:])):
            p1, p2 = f"01partial/pair{i}_k{k1}", f"01partial/pair{i}_k{k2}"
            if workdir and ckpt.has_kset(workdir, p1) \
                    and ckpt.has_kset(workdir, p2):
                sorted_sets[k1] = ckpt.load_kset(workdir, p1)
                sorted_sets[k2] = ckpt.load_kset(workdir, p2)
                continue
            shorts, longs = reduce_k_pair(sorted_sets[k1], sorted_sets[k2],
                                          k1, k2, device=device)
            sorted_sets[k1], sorted_sets[k2] = shorts, longs
            log.info("reduce %d vs %d: %d short k-mers kept", k1, k2,
                     len(shorts[0]))
            if workdir:
                ckpt.save_kset(workdir, p1, shorts, k1)
                ckpt.save_kset(workdir, p2, longs, k2)
        pool = records_from_sorted(
            [(*v, k) for k, v in sorted_sets.items()])
        del sorted_sets
        if workdir:
            ckpt.save_records(workdir, "01reduced", pool)
            ckpt.clear_partial(workdir, "01partial")
        lap("meta/01reduce")

    if resume_idx < 2:
        rounds0 = met.counts.get("meta/rounds", 0)
        ckpt_dir = os.path.join(workdir, "02partial") if workdir else None
        if mesh is not None:
            pool = run_dyn_extension_mesh(pool, params, kmin=kmin, seed=seed,
                                          ckpt_dir=ckpt_dir, mesh=mesh)
        else:
            pool = run_dyn_extension(pool, params, kmin=kmin, seed=seed,
                                     ckpt_dir=ckpt_dir, device=device)
        met.set("meta/extension_rounds",
                met.counts.get("meta/rounds", 0) - rounds0)
        if workdir:
            ckpt.save_records(workdir, "02extended", pool)
            ckpt.clear_partial(workdir, "02partial")
        lap("meta/02extend")
        met.set("meta/live_after_extension",
                pool.n if mesh is not None else sum(len(g[1]) for g in pool))

    if resume_idx < 3:
        fix_ns = os.path.join(workdir, "03partial") if workdir else None
        fast = os.environ.get("REFLEXIV_FAST_FIXING") == "1" or kmax < 32
        if fast and mesh is not None:
            pool = fixing_rounds_mesh(pool, params, kfix=min(31, kmin),
                                      seed=seed + 1000, ckpt_ns=fix_ns,
                                      mesh=mesh)
        elif fast:
            if isinstance(pool, list):
                dense = groups_to_dense(pool)
                pool = PackedDynRecords(*dense, np.ones(len(dense[1]), bool))
            pool = fixing_rounds(pool, params, kfix=min(31, kmin),
                                 seed=seed + 1000, ckpt_ns=fix_ns,
                                 device=device)
        else:
            pool = fixing_rounds_faithful(pool, params, kmax=kmax,
                                          seed=seed + 1000, ckpt_ns=fix_ns,
                                          device=device, mesh=mesh)
        if workdir:
            ckpt.save_records(workdir, "03fixed", pool)
            ckpt.clear_partial(workdir, "03partial")
        lap("meta/03fixing")

    if resume_idx < 4:
        if mesh is not None:
            raw = decode_flat_to_raw(pool, params)
        elif isinstance(pool, list):
            raw = decode_groups_to_raw(pool, params)
        else:
            raw = _decode_pool_to_raw(pool, params)
        del pool
        from .mapping import end_extend_arrays
        from .reassemble import parse_contig_attrs, reassemble_arrays

        # read-graph reassembly bridges fragment-scale contigs; longer ones
        # skip it and keep their ends for end extension and the extend pass
        kfix = min(31, kmin)
        ra_max = int(os.environ.get("REFLEXIV_REASSEMBLE_MAX_BASES",
                                    "65536"))
        small = [s for s, _, _ in raw if len(s) <= ra_max]
        big_rs = [row for row in raw if len(row[0]) > ra_max]
        met.set("meta/reassembly_fragments", len(small))
        re_out = [(s,) + parse_contig_attrs(h) for h, s in reassemble_arrays(
            *on_device(), small, dataclasses.replace(params, k=kfix),
            seed=seed + 2000, device=device, plain=plain)] if small else []
        raw = re_out + big_rs
        exts = end_extend_arrays([s for s, _, _ in raw], *on_device(),
                                 plain=plain)
        raw = [(s2, l, r) for s2, (_s, l, r) in zip(exts, raw)]
        lap("meta/04reassemble_end_extend")

        if raw and os.environ.get("REFLEXIV_SKIP_EXTEND_PASS") != "1":
            rows = [(encode_ascii(np.frombuffer(s.encode(), np.uint8)),
                     kfix - 1, l, r) for s, l, r in raw]
            if mesh is not None:
                flat = flat_from_rows(rows)
                flat = fixing_rounds_mesh(
                    flat, params, kfix=kfix, seed=seed + 3000, mesh=mesh) \
                    if kmax < 32 else fixing_rounds_faithful(
                        flat, params, kmax=kmax, seed=seed + 3000, mesh=mesh)
                raw = decode_flat_to_raw(flat, params)
            elif kmax >= 32:
                raw = decode_groups_to_raw(fixing_rounds_faithful(
                    groups_from_contig_rows(rows), params, kmax=kmax,
                    seed=seed + 3000, device=device), params)
            else:
                raw = _decode_pool_to_raw(fixing_rounds(
                    dyn_pool_from_rows(rows), params, kfix=kfix,
                    seed=seed + 3000, device=device), params)
            lap("meta/05extend_pass")

        attrs = {s: (l, r) for s, l, r in raw}
        deduped = [(s,) + attrs.get(s, (0, 0))
                   for s in dedup_contigs([s for s, _, _ in raw])]
        if workdir:
            ckpt.save_contigs_attrs(workdir, "04contigs", deduped)
        lap("meta/06finalize")
        met.set("meta/contigs", len(deduped))
    else:
        deduped = ckpt.load_contigs_attrs(workdir, "04contigs")

    # >Contig-<len>-(<left>,<right>)-<idx> (ReflexivDSMain.java:715-795)
    return [(f">Contig-{len(s)}-({l},{r})-{i}", s)
            for i, (s, l, r) in enumerate(deduped)]


def dynamic_assembly(params: Params, *, seed: int = 0, device,
                     plain: bool = False,
                     mesh: Optional["parallel.Mesh"] = None) -> None:
    """The ``meta`` command (``dynamic.dynamic_assembly``; on ``mesh`` when
    one is given, as the JAX command takes one over several devices):
    assemble with checkpoints under ``<out>/steps``, patch with
    ``-patch``/``-scaffold`` (the link table, when it has rows, to
    ``<out>/04Patching/links.tsv``), and write
    ``<out>/Assembly/part-00000``, ``_SUCCESS`` and
    ``assembly_report.txt``."""
    from .contigs import assembly_stats, write_assembly_report
    from .io import (load_reads_filtered, write_contigs_fasta,
                     write_success_marker)

    met = metrics.current()
    t0 = time.perf_counter()
    mat, lens = load_reads_filtered(
        params.input_fastq or params.input_fasta, params)
    met.add_time("meta/ingest", time.perf_counter() - t0)
    contigs = assemble_dynamic(
        mat, lens, params, seed=seed, device=device, plain=plain,
        workdir=os.path.join(params.output_path, "steps"), mesh=mesh)
    if params.patch or params.scaffold:
        from .patching import apply_patching

        t0 = time.perf_counter()
        contigs, links = apply_patching(contigs, params, device=device)
        if links:
            ldir = os.path.join(params.output_path, "04Patching")
            os.makedirs(ldir, exist_ok=True)
            with open(os.path.join(ldir, "links.tsv"), "w") as fh:
                fh.write("contig_a\tend_a\tcontig_b\tend_b\tn_links\tgap\n")
                for row in links:
                    fh.write("\t".join(str(x) for x in row) + "\n")
        met.add_time("meta/07patching", time.perf_counter() - t0)
        met.set("meta/patching_links", len(links))
    out_dir = os.path.join(params.output_path, "Assembly")
    write_contigs_fasta(os.path.join(out_dir, "part-00000"), contigs,
                        gzip_output=params.gzip_output)
    write_success_marker(out_dir)
    write_assembly_report(os.path.join(out_dir, "assembly_report.txt"),
                          contigs)
    stats = assembly_stats(contigs)
    log.info("meta assembly: %d contigs -> %s (canonicalized: n=%d "
             "total=%dbp longest=%d N50=%d)", len(contigs), out_dir,
             stats["n_contigs"], stats["total_bp"], stats["longest"],
             stats["n50"])
