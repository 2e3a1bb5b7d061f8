"""Host-resident mixed-k record pools of ``meta`` (the numpy half of
``reflexiv_tpu.dynamic``'s summary-indexed extension rounds).

A pool row is a mixed-k record: 2-bit packed sequence limbs (16 bases per
uint32 limb, left-aligned, zero past ``2 * length`` bits: the
``reflexiv_tpu.packed`` layout), its length, its sub-k-mer (join overlap)
length ``subk`` and its two end attrs. The bytes stay in host memory; each
round the device sees fixed-width row summaries (the ``max_sub``-base
head and tail windows and the first/last 16 bases the orientation draw
hashes, :func:`host_summaries`) and returns merge instructions, which the
host applies here as packed splices.

:class:`RaggedPool` keeps short rows in one dense matrix and rows longer
than ``W_DENSE`` limbs as trimmed overflow arrays, so memory stays near
the total bases. Width-class groups ``[(seq, length, subk, left, right),
...]`` are the parked, checkpoint and stage-handoff format.

Everything here is numpy; every function gives the JAX package's arrays
bit for bit, row order included.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

BASES_PER_LIMB = 16
_M32 = 0xFFFFFFFF


def limbs_for(n_bases: int) -> int:
    return (n_bases + BASES_PER_LIMB - 1) // BASES_PER_LIMB


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class DynRecords(NamedTuple):
    """Byte-form mixed-k pool on the host (``dynamic.DynRecords``)."""

    seq: np.ndarray      # (N, L) uint8 base codes
    length: np.ndarray   # (N,) int32
    subk: np.ndarray     # (N,) int32, sub-k-mer (join overlap) length
    left: np.ndarray     # (N,) int32
    right: np.ndarray    # (N,) int32
    live: np.ndarray     # (N,) bool


class PackedDynRecords(NamedTuple):
    """Packed mixed-k pool on the host (``packed_dyn.PackedDynRecords``)."""

    seq: np.ndarray      # (N, LW) uint32 limbs
    length: np.ndarray
    subk: np.ndarray
    left: np.ndarray
    right: np.ndarray
    live: np.ndarray

    @property
    def capacity(self) -> int:
        return self.seq.shape[0]

    @property
    def limb_capacity(self) -> int:
        return self.seq.shape[1]

    @property
    def base_capacity(self) -> int:
        return self.seq.shape[1] * BASES_PER_LIMB


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_seq_matrix_np(bases: np.ndarray) -> np.ndarray:
    """(N, L) uint8 codes -> (N, ceil(L/16)) uint32 left-aligned limbs
    (``packed.pack_seq_matrix_np``); codes past each row's length must be
    zero."""
    N, L = bases.shape
    LW = limbs_for(L)
    pad = LW * BASES_PER_LIMB - L
    if pad:
        bases = np.pad(bases, ((0, 0), (0, pad)))
    # four codes per byte, first base high; four bytes read big-endian
    # are the limb
    q = bases.reshape(N, LW * 4, 4)
    packed = (q[:, :, 0] << 6) | (q[:, :, 1] << 4) | (q[:, :, 2] << 2) \
        | q[:, :, 3]
    return np.ascontiguousarray(packed, np.uint8).view(">u4") \
        .reshape(N, LW).astype(np.uint32)


def unpack_seq_matrix_np(seq: np.ndarray, L: int) -> np.ndarray:
    """(N, LW) limbs -> (N, L) uint8 codes (``packed.unpack_seq_matrix_np``)."""
    N, LW = seq.shape
    byte = np.ascontiguousarray(seq, ">u4").view(np.uint8).reshape(N, LW * 4)
    out = np.empty((N, LW * 4, 4), np.uint8)
    for i in range(4):
        out[:, :, i] = (byte >> (6 - 2 * i)) & 3
    return out.reshape(N, LW * BASES_PER_LIMB)[:, :L]


def unpack_rows_np(seq: np.ndarray, n_bases: int) -> np.ndarray:
    """(N, W) limbs -> (N, n_bases) codes, zero past the limbs
    (``dynamic._unpack_rows_np``)."""
    N, W = seq.shape
    j = np.arange(n_bases)
    sh = (30 - 2 * (j % 16)).astype(np.uint32)
    vals = (seq[:, np.minimum(j // 16, W - 1)] >> sh[None, :]) & np.uint32(3)
    if n_bases > W * 16:
        vals[:, W * 16:] = 0
    return vals.astype(np.uint8)


_HOST_BLOCK_ROWS = 1 << 20


def from_dyn_host(d: DynRecords) -> PackedDynRecords:
    """Byte pool -> packed pool, blockwise, bases past each length zeroed
    (``packed_dyn.from_dyn_host``, kept on the host)."""
    seq = np.asarray(d.seq)
    length = np.asarray(d.length)
    N, L = seq.shape
    packed = np.empty((N, limbs_for(L)), np.uint32)
    col = np.arange(L)
    for lo in range(0, N, _HOST_BLOCK_ROWS):
        hi = min(lo + _HOST_BLOCK_ROWS, N)
        packed[lo:hi] = pack_seq_matrix_np(
            np.where(col[None, :] < length[lo:hi, None], seq[lo:hi], 0))
    return PackedDynRecords(packed, length, np.asarray(d.subk),
                            np.asarray(d.left), np.asarray(d.right),
                            np.asarray(d.live))


def to_dyn_host(p: PackedDynRecords) -> DynRecords:
    """Packed pool -> byte pool (``packed_dyn.to_dyn_host``)."""
    N, L = p.capacity, p.base_capacity
    seq = np.empty((N, L), np.uint8)
    for lo in range(0, N, _HOST_BLOCK_ROWS):
        hi = min(lo + _HOST_BLOCK_ROWS, N)
        seq[lo:hi] = unpack_seq_matrix_np(p.seq[lo:hi], L)
    return DynRecords(seq, p.length, p.subk, p.left, p.right, p.live)


def groups_to_dense(groups):
    """Width-class groups -> one all-live ``(seq, length, subk, left,
    right)`` tuple (``dynamic._groups_to_dense``)."""
    if not groups:
        z = np.zeros(0, np.int32)
        return (np.zeros((0, 1), np.uint32), z, z, z, z)
    total = sum(len(g[1]) for g in groups)
    W = max(g[0].shape[1] for g in groups)
    seq = np.zeros((total, W), np.uint32)
    cols = [np.empty(total, np.int32) for _ in range(4)]
    lo = 0
    for g in groups:
        n = len(g[1])
        seq[lo:lo + n, :g[0].shape[1]] = g[0]
        for c, a in zip(cols, g[1:]):
            c[lo:lo + n] = a
        lo += n
    return (seq, *cols)


# ---------------------------------------------------------------------------
# windows, summaries, splices
# ---------------------------------------------------------------------------

def host_window(seq: np.ndarray, start: np.ndarray, width: int):
    """Left-aligned packed window of ``width`` bases from per-row ``start``
    over (N, LW) limb rows, zeros past the row data
    (``dynamic._host_window``)."""
    N = seq.shape[0]
    W = limbs_for(width)
    padded = np.concatenate([seq, np.zeros((N, W + 1), np.uint32)], axis=1)
    rows = np.arange(N)
    q = start // BASES_PER_LIMB
    o = (2 * (start % BASES_PER_LIMB)).astype(np.uint32)
    out = np.empty((N, W), np.uint32)
    for j in range(W):
        a = padded[rows, q + j]
        b = padded[rows, q + j + 1]
        bs = b >> ((np.uint32(32) - o) & np.uint32(31))
        out[:, j] = np.where(o > 0, (a << o) | bs, a)
    rem = width - BASES_PER_LIMB * (W - 1)
    if rem < BASES_PER_LIMB:
        out[:, W - 1] &= np.uint32(_M32) << (32 - 2 * rem)
    return out


def host_summaries(hp, max_sub: int):
    """Per-row summaries ``(head, tail, head16, tail16)``: the
    ``max_sub``-base windows at the head and at ``length - subk``, and the
    first/last 16 bases the orientation draw hashes
    (``dynamic._host_summaries``)."""
    seq, length, subk = hp[0], hp[1], hp[2]
    N = seq.shape[0]
    start0 = np.zeros(N, np.int64)
    head = host_window(seq, start0, max_sub)
    tailw = host_window(
        seq, np.maximum(length.astype(np.int64) - subk, 0), max_sub)
    n16 = min(16, seq.shape[1] * BASES_PER_LIMB)
    h16 = host_window(seq, start0, n16)[:, 0]
    t16 = host_window(
        seq, np.maximum(length.astype(np.int64) - n16, 0), n16)[:, 0]
    if n16 < BASES_PER_LIMB:
        h16 = h16 >> np.uint32(32 - 2 * n16)
        t16 = t16 >> np.uint32(32 - 2 * n16)
    return (head, tailw, h16, t16)


def host_concat_packed(seq_a, len_a, seq_b, len_b, skip, out_limbs: int):
    """Per-row ``a ++ b[skip:]`` on packed rows, vectorised over rows
    (``dynamic._host_concat_packed``). Returns (rows, total lengths)."""
    M = len(len_a)
    total = (len_a + len_b - skip).astype(np.int32)
    out = np.zeros((M, out_limbs), np.uint32)
    la = min(seq_a.shape[1], out_limbs)
    out[:, :la] = seq_a[:, :la]
    padded_b = np.concatenate([seq_b, np.zeros((M, 2), np.uint32)], axis=1)
    LB = seq_b.shape[1]
    rows = np.arange(M)
    len_a64 = len_a.astype(np.int64)
    for m in range(out_limbs):
        base0 = m * BASES_PER_LIMB
        bpos = np.maximum(base0 - len_a64, 0) + skip
        q = np.minimum(bpos // BASES_PER_LIMB, LB)
        o = (2 * (bpos % BASES_PER_LIMB)).astype(np.uint32)
        a_ = padded_b[rows, q]
        b_ = padded_b[rows, q + 1]
        bs = b_ >> ((np.uint32(32) - o) & np.uint32(31))
        pb = np.where(o > 0, (a_ << o) | bs, a_)
        shift = (2 * np.clip(len_a64 - base0, 0, BASES_PER_LIMB)
                 ).astype(np.uint32)
        pb = np.where(shift >= 32, 0, pb >> np.minimum(shift, np.uint32(31)))
        valid = np.clip(total.astype(np.int64) - base0, 0, BASES_PER_LIMB)
        mask = np.where(
            valid >= BASES_PER_LIMB, _M32,
            np.where(valid > 0, (np.int64(_M32) << (32 - 2 * valid)) & _M32,
                     0)).astype(np.uint32)
        out[:, m] = (out[:, m] | pb) & mask
    return out, total


def host_concat_row(a: np.ndarray, la: int, b: np.ndarray, lb: int,
                    skip: int):
    """One row's ``a ++ b[skip:]``, vectorised over limbs
    (``dynamic._host_concat_row``; for the long overflow rows)."""
    total = la + lb - skip
    W = limbs_for(max(total, 1))
    out = np.zeros(W, np.uint32)
    wa = limbs_for(la) if la else 0
    out[:wa] = a[:wa]
    nb = lb - skip
    if nb > 0:
        q = skip // BASES_PER_LIMB
        o = np.uint32(2 * (skip % BASES_PER_LIMB))
        wb = limbs_for(nb)
        aa = np.zeros(wb, np.uint32)
        seg = b[q:q + wb]
        aa[:len(seg)] = seg
        if o:
            bb = np.zeros(wb, np.uint32)
            seg2 = b[q + 1:q + 1 + wb]
            bb[:len(seg2)] = seg2
            bs = (aa << o) | (bb >> (np.uint32(32) - o))
        else:
            bs = aa
        remb = nb - BASES_PER_LIMB * (wb - 1)
        if remb < BASES_PER_LIMB:
            bs[-1] &= np.uint32(_M32) << (32 - 2 * remb)
        p = la // BASES_PER_LIMB
        po = np.uint32(2 * (la % BASES_PER_LIMB))
        if po:
            end0 = min(p + wb, W)
            out[p:end0] |= (bs >> po)[:end0 - p]
            end1 = min(p + 1 + wb, W)
            out[p + 1:end1] |= (bs << (np.uint32(32) - po))[:end1 - p - 1]
        else:
            end0 = min(p + wb, W)
            out[p:end0] |= bs[:end0 - p]
    return out, total


def summaries_rows(rows, lengths, subks, max_sub: int):
    """Summaries of a few trimmed rows, one at a time
    (``dynamic._summaries_rows``)."""
    SW = limbs_for(max_sub)
    M = len(rows)
    head = np.zeros((M, SW), np.uint32)
    tail = np.zeros((M, SW), np.uint32)
    h16 = np.zeros(M, np.uint32)
    t16 = np.zeros(M, np.uint32)
    zero = np.zeros(1, np.int64)
    for i, arr in enumerate(rows):
        a2 = arr[None, :]
        ln = np.asarray([int(lengths[i])], np.int64)
        head[i] = host_window(a2, zero, max_sub)[0]
        tail[i] = host_window(a2, np.maximum(ln - int(subks[i]), 0),
                              max_sub)[0]
        h16[i] = host_window(a2, zero, 16)[0, 0]
        t16[i] = host_window(a2, np.maximum(ln - 16, 0), 16)[0, 0]
    return head, tail, h16, t16


def limb_masks(nbases: np.ndarray, W: int) -> np.ndarray:
    """(N, W) uint32 masks of each row's first ``nbases`` bases."""
    bits = np.clip(2 * (nbases.astype(np.int64)[:, None]
                        - BASES_PER_LIMB * np.arange(W)[None, :]), 0, 32)
    return np.where(
        bits >= 32, _M32,
        np.where(bits > 0, (np.int64(_M32) << (32 - bits)) & _M32, 0),
    ).astype(np.uint32)


# ---------------------------------------------------------------------------
# the ragged pool
# ---------------------------------------------------------------------------

class RaggedPool:
    """Host mixed-k pool of the indexed loop (``dynamic._RaggedPool``).

    Rows up to ``W_DENSE`` limbs live in one dense matrix; longer rows (the
    growing contigs, always few) live as trimmed overflow arrays in
    ``over``, keyed by row."""

    W_DENSE = 512   # limbs (8192 bases); a class attribute so tests shrink it

    def __init__(self, dense, length, subk, left, right, over):
        self.dense = dense          # (N, <= W_DENSE) uint32
        self.length = length
        self.subk = subk
        self.left = left
        self.right = right
        self.over = over            # {row: trimmed uint32 limbs}

    @property
    def n(self) -> int:
        return len(self.length)

    @classmethod
    def empty(cls) -> "RaggedPool":
        z = np.zeros(0, np.int32)
        return cls(np.zeros((0, 1), np.uint32), z, z, z, z, {})

    @classmethod
    def from_dense(cls, hp) -> "RaggedPool":
        seq, length, subk, left, right = hp
        wd = min(cls.W_DENSE, max(seq.shape[1], 1))
        over = {int(i): seq[i, :limbs_for(int(length[i]))].copy()
                for i in np.nonzero(length > wd * 16)[0]}
        return cls(np.ascontiguousarray(seq[:, :wd]),
                   length.astype(np.int32), subk.astype(np.int32),
                   left.astype(np.int32), right.astype(np.int32), over)

    @classmethod
    def from_groups(cls, groups) -> "RaggedPool":
        if not groups:
            return cls.empty()
        total = sum(len(g[1]) for g in groups)
        wd = min(cls.W_DENSE, max(max(g[0].shape[1] for g in groups), 1))
        dense = np.zeros((total, wd), np.uint32)
        cols = [np.empty(total, np.int32) for _ in range(4)]
        over = {}
        lo = 0
        for g in groups:
            n = len(g[1])
            w = min(g[0].shape[1], wd)
            dense[lo:lo + n, :w] = g[0][:, :w]
            for c, a in zip(cols, g[1:]):
                c[lo:lo + n] = a
            if g[0].shape[1] > wd:
                for j in np.nonzero(g[1] > wd * 16)[0]:
                    over[lo + int(j)] = \
                        g[0][j, :limbs_for(int(g[1][j]))].copy()
            lo += n
        return cls(dense, *cols, over)

    def row_seq(self, i: int):
        arr = self.over.get(int(i))
        if arr is not None:
            return arr
        return self.dense[i, :limbs_for(int(self.length[i]))]

    def to_groups(self) -> List[tuple]:
        """Width-class groups: dense rows by power-of-two limb class, then
        the overflow rows likewise (``_RaggedPool.to_groups``)."""
        groups = []
        over_rows = np.zeros(self.n, bool)
        if self.over:
            over_rows[np.fromiter(self.over, int, len(self.over))] = True
        short_idx = np.nonzero(~over_rows)[0]
        if len(short_idx):
            lens = self.length[short_idx]
            cls_w = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(
                (lens + 15) // 16, 1))).astype(np.int64))
            for w in np.unique(cls_w):
                sel = short_idx[cls_w == w]
                groups.append((
                    self.dense[sel][:, :min(int(w), self.dense.shape[1])]
                    .copy(),
                    self.length[sel].copy(), self.subk[sel].copy(),
                    self.left[sel].copy(), self.right[sel].copy()))
        if self.over:
            by_cls: dict = {}
            for i, arr in self.over.items():
                by_cls.setdefault(next_pow2(max(len(arr), 1)), []).append(i)
            for w, idxs in sorted(by_cls.items()):
                idxs = np.asarray(sorted(idxs))
                seq = np.zeros((len(idxs), w), np.uint32)
                for r, i in enumerate(idxs):
                    a = self.over[int(i)]
                    seq[r, :len(a)] = a
                groups.append((
                    seq, self.length[idxs].copy(), self.subk[idxs].copy(),
                    self.left[idxs].copy(), self.right[idxs].copy()))
        return groups

    def select(self, idx: np.ndarray) -> "RaggedPool":
        """New pool of rows ``idx``, in that order. Only the overflow rows
        are visited one by one."""
        remap = {}
        if self.over:
            keys = np.fromiter(self.over, np.int64, len(self.over))
            for new_i in np.nonzero(np.isin(idx, keys))[0]:
                remap[int(new_i)] = self.over[int(idx[new_i])]
        return RaggedPool(self.dense[idx], self.length[idx], self.subk[idx],
                          self.left[idx], self.right[idx], remap)


def summaries_ragged(pool: RaggedPool, max_sub: int):
    """Summaries of a whole :class:`RaggedPool`: the dense part at once,
    the overflow rows one by one (``dynamic._summaries_ragged``)."""
    head, tailw, h16, t16 = host_summaries(
        (pool.dense, np.minimum(pool.length, pool.dense.shape[1] * 16),
         pool.subk), max_sub)
    if pool.over:
        idxs = sorted(pool.over)
        oh, ot, oh16, ot16 = summaries_rows(
            [pool.over[i] for i in idxs], pool.length[idxs],
            pool.subk[idxs], max_sub)
        head[idxs], tailw[idxs] = oh, ot
        h16[idxs], t16[idxs] = oh16, ot16
    return head, tailw, h16, t16
