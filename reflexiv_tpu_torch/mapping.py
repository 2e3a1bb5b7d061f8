"""Contig-end extension by read consensus (``reflexiv_tpu.mapping``'s
device form, the ``07EndExtend`` stage of ``meta``).

The reference maps reads onto contig ends with an external minimap2 and
extends each end by the reads' consensus (``ReflexivDSDynamicKmerMapping``).
Here the terminal ``ANCHOR`` bases of each contig are looked up among the
windows of every read, on both strands, and the bases following each hit
vote column by column: a column is taken while it has at least
``MIN_SUPPORT`` votes and its best base holds at least 70% of them, tested
in integers as ``best * 10 >= 7 * total`` (the JAX device form, which is
its default for this stage on every platform).

The index holds one int64 per read window: the top bits of the window's
canonical k-mer above the window's id. The extraction kernel cuts the
canonical keys and the one-word radix kernel sorts the entries, in row
chunks of at most 2^30 windows each searched in turn, so any number of
reads fits the sort's 32-bit offsets. A lookup
takes the entries whose top bits match the query's canonical k-mer
(``torch.searchsorted``) and checks each against the read bases: the
window's canonical k-mer must equal the query's, and which strand equals
the query gives the hit's orientation. For odd k no k-mer is its own
reverse complement, so each matching window is a hit on exactly one
strand, as in the JAX package's two-strand index; the votes are counted
with one ``bincount`` per batch of hits.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .bitpack import decode_to_str, encode_ascii
from .contigs import revcomp_str
from .kernels import extract as extract_mod
from .kernels import radix_sort

ANCHOR = 31           # seed length, the reference's fixing k-mer size
MIN_SUPPORT = 2       # reads required to accept an extension column
MAJORITY_TENTHS = 7   # column majority, 0.7 as tenths
HIT_CHUNK = 1 << 17   # hits voted per bincount
ENTRY_BITS = 62       # the radix kernel sorts 62-bit words
INDEX_WINDOWS = 1 << 30   # windows one sorted index chunk holds


def _pack(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) codes -> forward keys, first base high."""
    key = torch.zeros(codes.shape[:-1], dtype=torch.int64,
                      device=codes.device)
    for j in range(k):
        key |= codes[..., j].to(torch.int64) << (2 * (k - 1 - j))
    return key


def _canonical(fwd: torch.Tensor, k: int) -> torch.Tensor:
    rc = torch.zeros_like(fwd)
    for j in range(k):
        rc |= (3 - ((fwd >> (2 * (k - 1 - j))) & 3)) << (2 * j)
    return torch.minimum(fwd, rc)


class WindowIndex:
    """Every ``k``-base window of a read matrix (odd ``k`` <= 31), in row
    chunks of at most :data:`INDEX_WINDOWS` windows. Each chunk holds
    sorted int64 entries ``(canonical key >> shift) << id_bits | window
    id`` for its own windows, so ``id_bits`` stays at most 30 and the
    radix sort's 32-bit offsets never bind, whatever the read count;
    ``plain=True`` cuts and sorts them with the kernels' plain torch
    versions."""

    def __init__(self, bases: torch.Tensor, lengths: torch.Tensor, k: int,
                 *, plain: bool = False):
        if k % 2 == 0 or k > 31:
            raise ValueError(f"anchor k={k} must be odd and at most 31")
        self.k = k
        self.bases = bases
        self.lengths = lengths.to(torch.int64)
        R, L = bases.shape
        self.wn = max(L - k + 1, 0)
        rows = max(1, INDEX_WINDOWS // max(self.wn, 1))
        self.chunks = [self._chunk(lo, min(lo + rows, R), plain)
                       for lo in range(0, R, rows) if self.wn]

    def _chunk(self, lo: int, hi: int, plain: bool):
        """``(first row, id_bits, shift, sorted entries)`` of rows
        ``[lo, hi)``."""
        k, n = self.k, (hi - lo) * self.wn
        id_bits = max(n - 1, 1).bit_length()
        shift = max(2 * k - (ENTRY_BITS - id_bits), 0)
        bases, lens32 = self.bases[lo:hi], self.lengths[lo:hi].to(torch.int32)
        if plain:
            keys = extract_mod.extract_canonical_keys_torch(
                bases, lens32, k=k)
        else:
            keys = extract_mod.extract_canonical_keys(bases, lens32, k=k)
        keys = ((keys >> shift) << id_bits) | torch.arange(
            n, dtype=torch.int64, device=bases.device)
        entries = radix_sort.sort_keys_torch(keys) if plain else \
            radix_sort.sort_keys(keys, bits=ENTRY_BITS)
        return lo, id_bits, shift, entries

    def hits(self, query: torch.Tensor):
        """Forward query keys (C,) -> (owner, row, end, strand) of every
        hit: the window of ``k`` bases ending at ``end`` on ``strand`` (0
        the read, 1 its reverse complement) of read ``row`` equals query
        ``owner``. Hits come chunk by chunk."""
        k, dev = self.k, query.device
        canon = _canonical(query, k)
        owners, rows, js = [], [], []
        for lo, id_bits, shift, entries in self.chunks:
            top = canon >> shift
            first = torch.searchsorted(entries, top << id_bits)
            cnt = torch.searchsorted(entries, (top + 1) << id_bits) - first
            owner = torch.repeat_interleave(
                torch.arange(len(query), device=dev), cnt)
            ptr = first[owner] + torch.arange(owner.numel(), device=dev) \
                - (torch.cumsum(cnt, 0) - cnt)[owner]
            wid = entries[ptr] & ((1 << id_bits) - 1)
            owners.append(owner)
            rows.append(lo + wid // self.wn)
            js.append(wid % self.wn)
        owner, row, j = (torch.cat(t) if t else
                         torch.zeros(0, dtype=torch.int64, device=dev)
                         for t in (owners, rows, js))
        n = self.lengths[row]
        cols = (j[:, None] + torch.arange(k, device=dev)).clamp(
            max=self.bases.shape[1] - 1)
        fwd = _pack(self.bases[row[:, None], cols], k)
        # a candidate shares only the key's top bits: its bases decide
        ok = (j + k <= n) & (_canonical(fwd, k) == canon[owner])
        owner, row, j, n, fwd = (t[ok] for t in (owner, row, j, n, fwd))
        strand = (fwd != query[owner]).to(torch.int64)
        end = torch.where(strand == 0, j + k, n - j)
        return owner, row, end, strand


def _anchor_keys(tails: List[str], k: int, device) -> torch.Tensor:
    codes = torch.from_numpy(encode_ascii(np.frombuffer(
        "".join(tails).encode(), np.uint8)).reshape(len(tails), k))
    return _pack(codes.to(device), k)


def batch_extensions(seqs: List[str], active: List[int], index: WindowIndex,
                     anchor: int, max_tail: int) -> List[np.ndarray]:
    """One consensus round for every active contig: the codes each one
    grows by (``mapping._batch_extensions_device``)."""
    dev = index.bases.device
    C = len(active)
    owner, rows, ends, strand = index.hits(
        _anchor_keys([seqs[i][-anchor:] for i in active], anchor, dev))
    H = owner.numel()
    if H == 0:
        return [np.zeros(0, np.uint8) for _ in active]
    counts = torch.zeros(C * max_tail * 4, dtype=torch.int64, device=dev)
    pos = torch.arange(max_tail, device=dev)[None, :]
    L = index.bases.shape[1]
    for h0 in range(0, H, HIT_CHUNK):
        sl = slice(h0, h0 + HIT_CHUNK)
        row = rows[sl]
        n = index.lengths[row][:, None]
        colf = ends[sl][:, None] + pos
        rev = strand[sl][:, None] == 1
        col = torch.where(rev, n - 1 - colf, colf).clamp(0, L - 1)
        vals = index.bases[row[:, None], col].to(torch.int64)
        vals = torch.where(rev, vals ^ 3, vals)
        flat = ((owner[sl][:, None] * max_tail + pos) << 2) | vals
        counts += torch.bincount(flat[colf < n], minlength=counts.numel())
    counts = counts.view(C, max_tail, 4)
    tot = counts.sum(-1)
    best = counts.argmax(-1)    # the first of tied bases, as jnp.argmax
    bestc = counts.gather(-1, best[..., None])[..., 0]
    ok = (tot >= MIN_SUPPORT) & (bestc * 10 >= MAJORITY_TENTHS * tot)
    ext_len = torch.cumprod(ok.to(torch.int64), 1).sum(1)
    best, ext_len = best.to(torch.uint8).cpu().numpy(), ext_len.cpu().numpy()
    return [best[c, :ext_len[c]] for c in range(C)]


def _extend_right(seqs: List[str], index: WindowIndex, anchor: int,
                  max_rounds: int, max_tail: int) -> List[str]:
    seqs = list(seqs)
    active = [i for i, s in enumerate(seqs) if len(s) >= anchor]
    for _ in range(max_rounds):
        if not active:
            break
        exts = batch_extensions(seqs, active, index, anchor, max_tail)
        nxt = []
        for i, ext in zip(active, exts):
            if len(ext):
                seqs[i] = seqs[i] + decode_to_str(ext)
                nxt.append(i)
        active = nxt
    return seqs


def end_extend_arrays(contigs: List[str], bases: torch.Tensor,
                      lengths: torch.Tensor, *, anchor: int = ANCHOR,
                      max_rounds: int = 8, max_tail: int = 256,
                      plain: bool = False) -> List[str]:
    """Extend both ends of every contig by read consensus
    (``mapping.end_extend_arrays``): the right end, then the right end of
    the reverse complement. ``bases``/``lengths`` are the read matrix on
    the device the index is built on."""
    index = WindowIndex(bases, lengths, anchor, plain=plain)
    seqs = _extend_right(contigs, index, anchor, max_rounds, max_tail)
    seqs = _extend_right([revcomp_str(s) for s in seqs], index, anchor,
                         max_rounds, max_tail)
    return [revcomp_str(s) for s in seqs]
