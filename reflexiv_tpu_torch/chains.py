"""A single-k record pool whose memory does not grow with row length, for
``stitch``.

``stitch`` puts whole contigs (megabases) beside tens of millions of k-mer
records. The packed pool (:mod:`reflexiv_tpu_torch.packed`) stores every row
as wide as the longest, which at that scale is terabytes. A round reads
only each row's ends, though: the (k-1)-base windows at either end (the
group keys), the first and last 16 bases (the orientation draw), length
and end attrs. When forward row f takes ``refl ++ f[k-1:]``, the joined
row's head is refl's, its tail f's: refl's last k-1 bases are f's first,
since both rows share the group key. So this pool keeps those end
summaries per row, and each row's sequence as a chain of pieces: the
initial rows' sequences, never copied. A merge links refl's last piece
to f's first. Rows come out in the same order as the packed round's, row
for row (the same sort, pairing and gate, :func:`packed.pair_sorted`), so
the loop (:func:`assembler.extension_fixpoint`) and its contigs are the
packed loop's. Sequences are joined only for the emitted rows, by pointer
jumping over the piece links.

Needs k >= 16: every row then holds the 16 bases the draw reads at each
end.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import metrics
from .bitpack import MASK32, decode_to_str, encode_ascii, group_sentinel
from .contigs import revcomp_str
from .packed import (finished_from_keys, group_order, keys_from_windows,
                     pack_seq_matrix, pair_sorted)
from .packed_dyn import draw_markers
from .records import REPEAT_KILLED, Records, next_pow2


class ChainPool(NamedTuple):
    head: torch.Tensor     # (N,) or (N, W): first k-1 bases' group key
    tail: torch.Tensor     # last k-1 bases' group key
    head16: torch.Tensor   # (N,) int64: first 16 bases, a 32-bit value
    tail16: torch.Tensor   # last 16 bases
    length: torch.Tensor   # (N,) int32
    left: torch.Tensor     # (N,) int32
    right: torch.Tensor    # (N,) int32
    live: torch.Tensor     # (N,) bool
    first: torch.Tensor    # (N,) int64: the row's first piece
    last: torch.Tensor     # (N,) int64: its last piece

    @property
    def capacity(self) -> int:
        return self.length.shape[0]


class Pieces(NamedTuple):
    """The initial rows' sequences, one piece per initial row: codes
    ``seq[off[i]:off[i + 1]]``. ``nxt[i]`` is the piece after piece i in
    its row (-1 at the end); a later piece adds its bases after the first
    k-1."""
    seq: torch.Tensor      # (total,) uint8 codes
    off: torch.Tensor      # (P + 1,) int64
    nxt: torch.Tensor      # (P,) int64


def _ends(codes: torch.Tensor, length: torch.Tensor, k: int):
    """Raw head and tail keys (as if every row were live) and the 16-base
    end values of ``(N, L)`` code rows of the given lengths (>= k >= 16)."""
    sub = k - 1
    n = length.to(torch.int64)[:, None]

    def at_end(width):
        cols = n - width + torch.arange(width, device=codes.device)[None, :]
        return pack_seq_matrix(torch.gather(codes, 1, cols))

    ones = torch.ones(codes.shape[0], dtype=torch.bool, device=codes.device)
    return (keys_from_windows(pack_seq_matrix(codes[:, :sub]), ones, sub),
            keys_from_windows(at_end(sub), ones, sub),
            pack_seq_matrix(codes[:, :16])[:, 0], at_end(16)[:, 0])


def from_records(recs: Records, fragments: List[str], k: int
                 ) -> Tuple[ChainPool, Pieces]:
    """The pool ``reassemble.inject_fragments`` then ``packed.from_records``
    would give, as chains: with fragments, the live k-mer records in row
    order, then each fragment of at least k bases and its reverse
    complement as free-ended rows, in a pool of ``next_pow2`` rows; with
    none, the records as they are. Each initial row is its own piece."""
    if k < 16:
        raise ValueError(f"k={k}: the chain pool needs k >= 16")
    dev = recs.seq.device
    both = []
    for f in fragments:
        if len(f) >= k:
            both += [f, revcomp_str(f)]
    rows = torch.nonzero(recs.live).squeeze(1) if both else \
        torch.arange(recs.capacity, device=dev)
    n_old = rows.numel()
    cap = next_pow2(n_old + len(both)) if both else recs.capacity
    kseq = recs.seq[rows, :k]
    flen = torch.tensor([len(f) for f in both], dtype=torch.int64)
    off = torch.zeros(cap + 1, dtype=torch.int64)
    off[1:n_old + 1] = k * torch.arange(1, n_old + 1)
    off[n_old + 1:n_old + 1 + len(both)] = n_old * k + torch.cumsum(flen, 0)
    off[n_old + 1 + len(both):] = n_old * k + int(flen.sum())
    fcodes = encode_ascii(np.frombuffer("".join(both).encode(), np.uint8))
    seq = torch.cat([kseq.reshape(-1), torch.from_numpy(fcodes).to(dev)])

    length = torch.zeros(cap, dtype=torch.int32, device=dev)
    length[:n_old] = recs.length[rows]
    length[n_old:n_old + len(both)] = flen.to(torch.int32).to(dev)
    left = torch.zeros(cap, dtype=torch.int32, device=dev)
    right = torch.zeros(cap, dtype=torch.int32, device=dev)
    left[:n_old], right[:n_old] = recs.left[rows], recs.right[rows]
    left[n_old:n_old + len(both)] = -1
    right[n_old:n_old + len(both)] = -1
    live = torch.zeros(cap, dtype=torch.bool, device=dev)
    live[:n_old] = recs.live[rows]
    live[n_old:n_old + len(both)] = True

    head, tail, h16, t16 = _ends(kseq, length[:n_old], k)
    if both:
        width = max(len(f) for f in both)
        fmat = np.zeros((len(both), width), np.uint8)
        for i, f in enumerate(both):
            fmat[i, :len(f)] = encode_ascii(np.frombuffer(f.encode(),
                                                          np.uint8))
        ends = _ends(torch.from_numpy(fmat).to(dev),
                     length[n_old:n_old + len(both)], k)
        head, tail, h16, t16 = (torch.cat([a, b]) for a, b in
                                zip((head, tail, h16, t16), ends))

    def padded(t):
        out = torch.zeros((cap,) + t.shape[1:], dtype=t.dtype, device=dev)
        out[:t.shape[0]] = t
        return out

    ids = torch.arange(cap, device=dev)
    pool = ChainPool(padded(head), padded(tail), padded(h16), padded(t16),
                     length, left, right, live, ids, ids.clone())
    return pool, Pieces(seq, off.to(dev),
                        torch.full((cap,), -1, dtype=torch.int64, device=dev))


def _masked(raw: torch.Tensor, live: torch.Tensor, sub: int) -> torch.Tensor:
    """Group keys with dead rows set to the sentinel
    (:func:`packed.keys_from_windows`' convention)."""
    if raw.dim() == 2:
        return torch.where(live[:, None], raw, MASK32)
    return torch.where(live, raw, group_sentinel(sub))


def extension_round(p: ChainPool, pieces: Pieces, round_seed: int, *,
                    k: int) -> Tuple[ChainPool, torch.Tensor]:
    """One round (:func:`packed.extension_round_packed` on the chains):
    returns the pool in sorted row order and its live count; the merges
    link their pieces in ``pieces.nxt``."""
    sub = k - 1
    marker = torch.where(
        p.live, draw_markers(p.head16, p.tail16, p.length, round_seed), 0)
    raw = torch.where((marker == 1)[:, None] if p.head.dim() == 2
                      else marker == 1, p.head, p.tail)
    order, skey = group_order(_masked(raw, p.live, sub), marker)
    s = ChainPool(*(t[order] for t in p))
    pairing = pair_sorted(skey, marker[order], s.live, s.left, s.right,
                          s.length, sub)
    rows, rr = pairing.fwd, pairing.refl
    pieces.nxt[s.last[rr]] = s.first[rows]
    out = s._replace(
        head=s.head.index_copy(0, rows, s.head[rr]),
        head16=s.head16.index_copy(0, rows, s.head16[rr]),
        first=s.first.index_copy(0, rows, s.first[rr]),
        length=s.length.index_copy(0, rows, s.length[rr] + s.length[rows]
                                   - sub),
        left=s.left.index_copy(0, rows, pairing.new_left),
        right=s.right.index_copy(0, rows, pairing.new_right),
        live=s.live & ~pairing.absorbed)
    return out, out.live.sum()


def finished_mask(p: ChainPool, k: int) -> torch.Tensor:
    """The census (:func:`packed.finished_mask_packed`) from the end keys."""
    return finished_from_keys(_masked(p.head, p.live, k - 1),
                              _masked(p.tail, p.live, k - 1), p.live)


def park_finished_rows(p: ChainPool, fin: torch.Tensor, parked: list
                       ) -> ChainPool:
    """Move the rows flagged by ``fin`` into one all-live parked batch."""
    idx = torch.nonzero(fin).squeeze(1)
    if idx.numel():
        parked.append(ChainPool(*(t[idx] for t in p)))
    return p._replace(live=p.live & ~fin)


def run_extension_loop(p: ChainPool, pieces: Pieces, params, *,
                       seed: int = 0) -> List[ChainPool]:
    """:func:`assembler.run_extension_loop` on the chain pool: the pool,
    then the parked batches."""
    from .assembler import compact_quarter, extension_fixpoint

    k = params.k
    groups, it = extension_fixpoint(
        p, lambda p, it, n: extension_round(compact_quarter(p, n), pieces,
                                            seed + it, k=k),
        lambda p: finished_mask(p, k), park_finished_rows, params)
    metrics.current().set("run/extension_rounds", it)
    return groups


def _jump(ptr: torch.Tensor, val: torch.Tensor):
    """Pointer jumping to the end of every list: per element, the sum of
    ``val`` from it to its list's end and that end's index."""
    ptr, val = ptr.clone(), val.clone()
    end = torch.arange(ptr.numel(), device=ptr.device)
    while True:
        go = ptr >= 0
        if not bool(go.any()):
            return val, end
        nxt = ptr.clamp(min=0)
        val = val + torch.where(go, val[nxt], 0)
        end = torch.where(go, end[nxt], end)
        ptr = torch.where(go, ptr[nxt], -1)


def emit_contigs(groups: List[ChainPool], pieces: Pieces, *, k: int,
                 min_contig: int) -> List[Tuple[str, str]]:
    """``contigs.emit_contigs`` over the chain pool and its parked batches:
    the same rows, headers and order."""
    dev = pieces.seq.device
    sub = k - 1
    firsts, lens, attrs = [], [], []
    for g in groups:
        keep = g.live & (g.length >= min_contig) & ~(
            (g.left <= REPEAT_KILLED) & (g.right <= REPEAT_KILLED))
        firsts.append(g.first[keep])
        lens.append(g.length[keep].to(torch.int64))
        attrs.append(torch.stack([g.left[keep], g.right[keep]], 1))
    firsts, lens = torch.cat(firsts), torch.cat(lens)
    attrs = torch.cat(attrs).tolist()
    if not firsts.numel():
        return []
    plen = pieces.off[1:] - pieces.off[:-1]
    nxt = pieces.nxt
    prv = torch.full_like(nxt, -1)
    linked = torch.nonzero(nxt >= 0).squeeze(1)
    prv[nxt[linked]] = linked
    # bases from a piece to its row's end: a row's first piece adds all of
    # its bases, every later one those after the first k-1, so a row of
    # length n has n - after[q] bases before piece q
    after, _last = _jump(nxt, plen - sub)
    _zero, root = _jump(prv, torch.zeros_like(plen))
    # the contig each piece belongs to, and where its bases go
    contig_of = torch.full_like(nxt, -1)
    contig_of[firsts] = torch.arange(firsts.numel(), device=dev)
    cid = contig_of[root]
    sel = torch.nonzero(cid >= 0).squeeze(1)
    cid = cid[sel]
    is_root = root[sel] == sel
    base = torch.cumsum(lens, 0) - lens
    dest = base[cid] + torch.where(is_root, 0, lens[cid] - after[sel])
    src = pieces.off[sel] + torch.where(is_root, 0, sub)
    count = torch.where(is_root, plen[sel], plen[sel] - sub)
    step = torch.arange(int(count.sum()), device=dev) \
        - torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
    flat = torch.zeros(int(lens.sum()), dtype=torch.uint8, device=dev)
    flat[torch.repeat_interleave(dest, count) + step] = \
        pieces.seq[torch.repeat_interleave(src, count) + step]
    flat = flat.cpu().numpy()
    out: List[Tuple[str, str]] = []
    for i, (n, at) in enumerate(zip(lens.tolist(), base.tolist())):
        left, right = attrs[i]
        out.append((f">Contig-{n}-({left},{right})-{i}",
                    decode_to_str(flat[at:at + n])))
    return out
