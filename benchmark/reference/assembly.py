"""Plain PyTorch reference of Reflexiv's single-k ``run`` flow: reads ->
canonical k-mer counts -> coverage band -> both strands -> two fork-filter
passes -> extension rounds to the fixpoint -> contigs.

Written from the algorithm's rules (``ReflexivDSMain.java``, as the
repository's scalar oracle states them), not from the program: it shares
no code, state or table with it. Its own representation is different too.
A record is a chain of k-mers: its first and last k-mer, their count and
its two end attributes; a merge links the left record's last k-mer to the
right record's first, and the sequences are spelled out once, at the end.

The rules that fix the result, and so are followed exactly:
- a window's k-mer and its reverse complement count as one; k-mers whose
  count lies in ``[cover, maxcov]`` are solid;
- every solid k-mer enters on both strands. Pass 1 groups them by their
  first k-1 bases: the greatest (count, last base) wins, the others go,
  and the winner's right end is extendable (attribute ``-1 - min(count,
  100000)``) when it was alone or every loser has a count of at most
  ``error`` and at most half the winner's, else blocked (``k - 1``).
  Pass 2 does the same over pass 1's winners, grouped by their last k-1
  bases and deciding by the first base, for the left end;
- round ``i`` (from 1) draws each live record forward (keyed by its first
  k-1 bases) or reflected (by its last k-1): the low bit of murmur3's
  32-bit finalizer of ``head ^ rot16(tail) ^ length ^ salt``, where head
  and tail are the record's first and last 16 bases packed 2 bits a base,
  first base highest, and ``salt = (seed + i) * 0x9E3779B9 mod 2^32``;
  0 is forward;
- a forward record and a reflected record with the same key merge
  (reflected ++ forward past its first k-1 bases) when the four-case gate
  passes, with the end attributes it gives;
- the loop stops as the program's is specified: after a round in which
  the live count has been unchanged for a multiple of 3 rounds, if no
  live record has a partner key left; from ``miniter`` rounds on, after 12
  unchanged rounds; after ``maxiter`` rounds;
- contigs are the live records of at least ``mincontig`` bases.

Every step runs on whatever device the tensors are on. ``fingerprint_bits``
turns the exact count into a hashed one (the control, see ``count``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
WORD_BASES = 31          # bases a word holds (62 bits of an int64)
WINDOWS_PER_BLOCK = 1 << 26
ATTR_CAP = 100_000
REPEAT_KILLED = -10_000_000
ACGT = np.frombuffer(b"ACGT", np.uint8)


# ---------------------------------------------------------------- arithmetic

def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` in ``[0, 2^32)`` held in int64, by the
    16-bit halves of ``c`` so that no product passes 2^63."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def pack_words(bases: torch.Tensor) -> torch.Tensor:
    """``(N, m)`` 2-bit codes -> ``(N, ceil(m / 31))`` int64 words, 31 bases
    a word (the last holds the rest), first base highest. Comparing the
    word rows in order compares the base strings."""
    N, m = bases.shape
    W = -(-m // WORD_BASES)
    out = torch.zeros((N, W), dtype=torch.int64, device=bases.device)
    for j in range(m):
        w = j // WORD_BASES
        out[:, w] = (out[:, w] << 2) | bases[:, j].to(torch.int64)
    return out


def pack16(bases: torch.Tensor) -> torch.Tensor:
    """``(N, 16)`` codes -> 32-bit values, base j at bits ``30 - 2j``."""
    out = torch.zeros(bases.shape[0], dtype=torch.int64, device=bases.device)
    for j in range(16):
        out = (out << 2) | bases[:, j].to(torch.int64)
    return out


def lex_order(rows: torch.Tensor) -> torch.Tensor:
    """Order of ``(N, W)`` int64 rows, compared word by word."""
    order = torch.sort(rows[:, -1], stable=True).indices
    for w in range(rows.shape[1] - 2, -1, -1):
        order = order[torch.sort(rows[order, w], stable=True).indices]
    return order


def unique_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """``(distinct rows, inverse, counts)`` of ``(N, W)`` int64 rows."""
    if rows.shape[1] == 1:
        u, inv, cnt = torch.unique(rows[:, 0], return_inverse=True,
                                   return_counts=True)
        return u[:, None], inv, cnt
    order = lex_order(rows)
    srt = rows[order]
    start = torch.ones(srt.shape[0], dtype=torch.bool, device=rows.device)
    start[1:] = (srt[1:] != srt[:-1]).any(1)
    gid = torch.cumsum(start.to(torch.int64), 0) - 1
    inv = torch.empty_like(gid)
    inv[order] = gid
    n = int(gid[-1]) + 1 if gid.numel() else 0
    cnt = torch.zeros(n, dtype=torch.int64, device=rows.device) \
        .scatter_add_(0, gid, torch.ones_like(gid))
    return srt[start], inv, cnt


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise ``a < b`` of two ``(N, W)`` word matrices."""
    less = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(less)
    for w in range(a.shape[1]):
        less |= ~decided & (a[:, w] < b[:, w])
        decided |= a[:, w] != b[:, w]
    return less


# ------------------------------------------------------------------ counting

def _window_words(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Words of every k-base window of ``(R, L)`` codes: ``(R, L-k+1, W)``."""
    R, L = codes.shape
    n = L - k + 1
    W = -(-k // WORD_BASES)
    out = torch.zeros((R, n, W), dtype=torch.int64, device=codes.device)
    for j in range(k):
        w = j // WORD_BASES
        out[:, :, w] = (out[:, :, w] << 2) | codes[:, j:j + n].to(torch.int64)
    return out


def canonical_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The canonical k-mer (the lesser strand) of every window, as
    ``(windows, W)`` words, reads in order, windows in order."""
    R, L = codes.shape
    if L < k:
        raise ValueError(f"reads of {L} bases are shorter than k = {k}")
    fwd = _window_words(codes, k)
    # the reverse complement of the window at p is the window at L-k-p of
    # the reverse-complemented read
    rc = _window_words(3 - codes.flip(1), k).flip(1)
    W = fwd.shape[2]
    fwd, rc = fwd.reshape(-1, W), rc.reshape(-1, W)
    return torch.where(lex_less(rc, fwd)[:, None], rc, fwd)


def fingerprint(words: torch.Tensor, bits: int) -> torch.Tensor:
    """A ``bits``-bit hash of each word row."""
    h = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    for w in range(words.shape[1]):
        for half in (words[:, w] >> 32, words[:, w] & MASK32):
            h = fmix32(h ^ half)
    return h & ((1 << bits) - 1)


def count(codes: torch.Tensor, k: int, *, cover: int, maxcov: int,
          fingerprint_bits: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solid canonical k-mers of ``(R, L)`` read codes and their counts:
    ``((U, W) words, (U,) int64)``. Reads go through in blocks of
    :data:`WINDOWS_PER_BLOCK` windows.

    With ``fingerprint_bits`` the count is of a ``bits``-bit hash of the
    k-mer, not of the k-mer: k-mers whose hashes collide share one count,
    as a table keyed by a short fingerprint counts them. That breaks the
    configuration's exact count, and is the control."""
    R, L = codes.shape
    rows = max(1, WINDOWS_PER_BLOCK // (L - k + 1))
    keys = torch.cat([canonical_windows(codes[lo:lo + rows], k)
                      for lo in range(0, R, rows)])
    kmers, inv, counts = unique_rows(keys)
    del keys
    if fingerprint_bits is not None:
        fp = fingerprint(kmers, fingerprint_bits)
        _u, fp_id, _c = unique_rows(fp[:, None])
        total = torch.zeros(int(fp_id.max()) + 1, dtype=torch.int64,
                            device=fp.device).scatter_add_(0, fp_id, counts)
        counts = total[fp_id]
    del inv
    keep = (counts >= cover) & (counts <= maxcov)
    return kmers[keep], counts[keep]


def unpack_kmers(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`pack_words`' inverse: ``(U, W)`` words -> ``(U, k)`` codes."""
    out = torch.empty((kmers.shape[0], k), dtype=torch.uint8,
                      device=kmers.device)
    for j in range(k):
        w = j // WORD_BASES
        held = min(WORD_BASES, k - w * WORD_BASES)
        shift = 2 * (held - 1 - (j - w * WORD_BASES))
        out[:, j] = ((kmers[:, w] >> shift) & 3).to(torch.uint8)
    return out


# --------------------------------------------------------------------- graph

class Graph:
    """Both strands of the solid k-mers (``bases``, ``(2U, k)``), each one's
    dense ids of its first and last k-1 bases, and the fork-filtered
    records: the rows that won both passes, with their end attributes."""

    def __init__(self, kmers: torch.Tensor, counts: torch.Tensor, *, k: int,
                 error: int):
        dev = kmers.device
        fwd = unpack_kmers(kmers, k)
        self.k = k
        self.bases = torch.cat([fwd, 3 - fwd.flip(1)])
        cover = torch.cat([counts, counts])
        n = self.bases.shape[0]
        ends = torch.cat([pack_words(self.bases[:, :k - 1]),
                          pack_words(self.bases[:, 1:])])
        _u, ids, _c = unique_rows(ends)
        self.pre_id, self.suf_id = ids[:n], ids[n:]
        self.n_ids = int(ids.max()) + 1 if n else 0
        everyone = torch.ones(n, dtype=torch.bool, device=dev)
        win1, right = self._fork_pass(self.pre_id, cover,
                                      self.bases[:, k - 1], everyone, k, error)
        win2, left = self._fork_pass(self.suf_id, cover, self.bases[:, 0],
                                     win1, k, error)
        self.records = torch.nonzero(win2).squeeze(1)
        self.left = left[self.records]
        self.right = right[self.records]
        self.head16 = pack16(self.bases[:, :16])
        self.tail16 = pack16(self.bases[:, k - 16:])

    def _fork_pass(self, gid, cover, ext, valid, k: int, error: int):
        """Winners among ``valid`` rows grouped by ``gid`` (greatest cover,
        then greatest ``ext`` base), and the attribute of the grouped end."""
        dev = gid.device
        score = torch.where(valid, cover * 4 + ext.to(torch.int64), -1)
        best = torch.full((self.n_ids,), -1, dtype=torch.int64, device=dev) \
            .scatter_reduce_(0, gid, score, "amax")
        winner = valid & (score == best[gid])
        size = torch.zeros(self.n_ids, dtype=torch.int64, device=dev) \
            .scatter_add_(0, gid, valid.to(torch.int64))
        win_cover = best[gid] >> 2
        killable = (cover <= error) & (win_cover >= 2 * cover)
        bad = torch.zeros(self.n_ids, dtype=torch.int64, device=dev) \
            .scatter_add_(0, gid, (valid & ~winner & ~killable)
                          .to(torch.int64))
        extendable = (size[gid] == 1) | (bad[gid] == 0)
        attr = torch.where(extendable, -1 - cover.clamp(max=ATTR_CAP), k - 1)
        return winner, attr


# ---------------------------------------------------------------- extension

def _gate(f_left, f_right, r_left, r_right, f_ext, r_ext):
    """The four-case merge gate and the merged record's end attributes."""
    c1 = (f_left < 0) & (r_right < 0)
    c2 = (f_left >= 0) & (r_right >= 0)
    c3 = ~c1 & ~c2 & (f_left >= 0) & (f_left - r_ext >= 0)
    c4 = ~c1 & ~c2 & ~c3 & (r_right >= 0) & (r_right - f_ext >= 0)
    bubble = torch.where(c1 | c2, -1,
                         torch.where(c3, f_left - r_ext, r_right - f_ext))
    new_left = torch.where((bubble >= 0) & (f_left > 0), bubble, r_left)
    new_right = torch.where((bubble >= 0) & ~(f_left > 0), bubble, f_right)
    return c1 | c2 | c3 | c4, new_left, new_right


class Extension:
    """The records as k-mer chains, and the rounds over them."""

    def __init__(self, g: Graph):
        self.g = g
        self.first = g.records.clone()
        self.last = g.records.clone()
        self.nk = torch.ones_like(g.records)
        self.left = g.left.clone()
        self.right = g.right.clone()
        self.live = torch.ones(g.records.shape[0], dtype=torch.bool,
                               device=g.records.device)
        self.nxt = torch.full((g.bases.shape[0],), -1, dtype=torch.int64,
                              device=g.records.device)

    def n_live(self) -> int:
        return int(self.live.sum())

    def _slots(self, keys: torch.Tensor, owners: torch.Tensor):
        """Key -> owner table; each key may have one owner only."""
        slot = torch.full((self.g.n_ids,), -1, dtype=torch.int64,
                          device=keys.device)
        if keys.numel():
            if int(torch.bincount(keys).max()) > 1:
                raise RuntimeError("two records share an end key")
            slot[keys] = owners
        return slot

    def round(self, round_seed: int) -> None:
        g, k = self.g, self.g.k
        lv = torch.nonzero(self.live).squeeze(1)
        first, last = self.first[lv], self.last[lv]
        length = k + self.nk[lv] - 1
        tail = g.tail16[last]
        salt = ((round_seed & MASK32) * 0x9E3779B9) & MASK32
        h = fmix32(g.head16[first] ^ (((tail << 16) & MASK32) | (tail >> 16))
                   ^ length ^ salt)
        fwd = (h & 1) == 0
        slot = self._slots(g.pre_id[first[fwd]], lv[fwd])
        r_keys = g.suf_id[last[~fwd]]
        self._slots(r_keys, lv[~fwd])
        a = slot[r_keys]
        has = a >= 0
        A, B = a[has], lv[~fwd][has]
        merge, new_left, new_right = _gate(
            self.left[A], self.right[A], self.left[B], self.right[B],
            self.nk[A], self.nk[B])
        A, B = A[merge], B[merge]
        self.nxt[self.last[B]] = self.first[A]
        self.first[A] = self.first[B]
        self.nk[A] += self.nk[B]
        self.left[A] = new_left[merge]
        self.right[A] = new_right[merge]
        self.live[B] = False

    def n_finished(self) -> int:
        """Live records whose first k-1 bases are no live record's last
        k-1 and whose last k-1 are no live record's first k-1."""
        g = self.g
        lv = torch.nonzero(self.live).squeeze(1)
        heads, tails = g.pre_id[self.first[lv]], g.suf_id[self.last[lv]]
        is_head = torch.zeros(g.n_ids, dtype=torch.bool, device=lv.device)
        is_tail = torch.zeros_like(is_head)
        is_head[heads] = True
        is_tail[tails] = True
        return int((~is_tail[heads] & ~is_head[tails]).sum())

    def run(self, *, seed: int, maxiter: int, miniter: int) -> int:
        """Rounds to the fixpoint; returns the rounds run."""
        stable = 0
        n = prev = self.n_live()
        it = 0
        for it in range(1, maxiter + 1):
            self.round(seed + it)
            n = self.n_live()
            if n == prev:
                stable += 1
            else:
                stable, prev = 0, n
            if stable >= 3 and stable % 3 == 0 and self.n_finished() == n:
                break
            if it >= miniter and stable >= 12:
                break
        return it

    def contigs(self, min_contig: int) -> List[str]:
        """Sequences of the live records of at least ``min_contig`` bases."""
        g, k = self.g, self.g.k
        length = k + self.nk - 1
        keep = self.live & (length >= min_contig) & ~(
            (self.left <= REPEAT_KILLED) & (self.right <= REPEAT_KILLED))
        rec = torch.nonzero(keep).squeeze(1)
        if rec.numel() == 0:
            return []
        dev = rec.device
        # distance of every k-mer to the end of its chain, by pointer doubling
        idx = torch.arange(self.nxt.shape[0], device=dev)
        ptr = torch.where(self.nxt >= 0, self.nxt, idx)
        dist = (self.nxt >= 0).to(torch.int64)
        for _ in range(64):
            nxt_ptr = ptr[ptr]
            if bool((nxt_ptr == ptr).all()):
                break
            dist = dist + dist[ptr]
            ptr = nxt_ptr
        else:
            raise RuntimeError("a k-mer chain does not end")
        rec_of_end = torch.full_like(idx, -1)
        rec_of_end[self.last[rec]] = torch.arange(rec.numel(), device=dev)
        r = rec_of_end[ptr]
        node = torch.nonzero(r >= 0).squeeze(1)
        r = r[node]
        nk = self.nk[rec]
        if not torch.equal(torch.bincount(r, minlength=rec.numel()), nk):
            raise RuntimeError("a record's chain does not hold its k-mers")
        pos = nk[r] - 1 - dist[node]
        lens = (k + nk - 1)
        off = torch.cumsum(lens, 0) - lens
        flat = torch.empty(int(lens.sum()), dtype=torch.uint8, device=dev)
        head = pos == 0
        hn, hr = node[head], r[head]
        flat[(off[hr][:, None] + torch.arange(k, device=dev)).reshape(-1)] = \
            g.bases[hn].reshape(-1)
        tn, tr = node[~head], r[~head]
        flat[off[tr] + k - 1 + pos[~head]] = g.bases[tn, k - 1]
        text = ACGT[flat.cpu().numpy()].tobytes().decode()
        bounds = np.concatenate([[0], np.cumsum(lens.cpu().numpy())])
        return [text[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]


def assemble(codes, *, k: int, cover: int, maxcov: int, error: int,
             mincontig: int, maxiter: int, miniter: int, seed: int,
             device, fingerprint_bits: Optional[int] = None) -> dict:
    """The contigs of ``(R, L)`` read codes (numpy or tensor) at the
    configuration's parameters, with the counts along the way."""
    codes = torch.as_tensor(codes).to(device)
    kmers, counts = count(codes, k, cover=cover, maxcov=maxcov,
                          fingerprint_bits=fingerprint_bits)
    del codes
    g = Graph(kmers, counts, k=k, error=error)
    del kmers, counts
    ext = Extension(g)
    rounds = ext.run(seed=seed, maxiter=maxiter, miniter=miniter)
    contigs = ext.contigs(mincontig)
    return {"contigs": contigs, "solid_kmers": g.bases.shape[0] // 2,
            "records": int(g.records.numel()), "rounds": rounds}
