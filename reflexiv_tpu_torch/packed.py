"""2-bit packed record sequences and the extension round (``reflexiv_tpu.packed``).

Record sequences are 32-bit limbs, 16 bases per limb, left-aligned (base j
in limb ``j // 16`` at bit ``30 - 2 * (j % 16)``), with every bit past
``2 * length`` zero. The limbs are int64 tensors holding values in
``[0, 2^32)``: each left shift is masked to 32 bits, and a shift by 32
yields 0 as XLA's does, because a value below 2^32 shifted right by 32 is 0
and one shifted left by 32 is masked off.

The round is the JAX package's CPU form (lexsort + index join,
``packed.py:457-466`` / ``:498-507``) and the census its non-scatter-free
form (``:388-405``); both sorts are stable, so the rows come out in the same
order as there, row for row. A row's group key (its (k-1)-base end) is one
int64 up to k = 31 and above that the JAX package's limb row itself
(:func:`keys_from_windows`).
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from .bitpack import MASK32, group_sentinel, mix32
from .join_core import (first_per_segment, lexsort_rows, merge_gate,
                        segment_sum, segments)
from .records import Records, live_first_order

BASES_PER_LIMB = 16


def limbs_for(n_bases: int) -> int:
    return (n_bases + BASES_PER_LIMB - 1) // BASES_PER_LIMB


class PackedRecords(NamedTuple):
    seq: torch.Tensor      # (N, LW) int64 limbs in [0, 2^32), left-aligned
    length: torch.Tensor   # (N,) int32
    left: torch.Tensor     # (N,) int32
    right: torch.Tensor    # (N,) int32
    live: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.seq.shape[0]

    @property
    def limb_capacity(self) -> int:
        return self.seq.shape[1]

    @property
    def base_capacity(self) -> int:
        return self.seq.shape[1] * BASES_PER_LIMB


def pack_seq_matrix(bases: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 codes -> (N, ceil(L/16)) left-aligned limbs. Codes
    beyond each row's length must be zero."""
    N, L = bases.shape
    LW = limbs_for(L)
    grp = F.pad(bases, (0, LW * BASES_PER_LIMB - L)) \
        .reshape(N, LW, BASES_PER_LIMB)
    out = torch.zeros((N, LW), dtype=torch.int64, device=bases.device)
    # one bit field at a time: int64 temporaries stay (N, LW), not 16x that
    for i in range(BASES_PER_LIMB):
        out |= grp[:, :, i].to(torch.int64) << (30 - 2 * i)
    return out


def unpack_seq_matrix(seq: torch.Tensor, L: int) -> torch.Tensor:
    """(N, LW) limbs -> (N, L) uint8 codes."""
    N, LW = seq.shape
    out = torch.empty((N, LW, BASES_PER_LIMB), dtype=torch.uint8,
                      device=seq.device)
    for i in range(BASES_PER_LIMB):
        out[:, :, i] = (seq >> (30 - 2 * i)) & 3
    return out.reshape(N, LW * BASES_PER_LIMB)[:, :L]


def from_records(recs: Records) -> PackedRecords:
    """Byte records -> packed records (zeroing bases beyond length)."""
    col = torch.arange(recs.seq_capacity, device=recs.seq.device)[None, :]
    clean = torch.where(col < recs.length[:, None], recs.seq, 0) \
        .to(torch.uint8)
    return PackedRecords(pack_seq_matrix(clean), recs.length, recs.left,
                         recs.right, recs.live)


def _limb_lookup(seq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``seq[row, q]`` per row, 0 where ``q`` is out of range."""
    LW = seq.shape[1]
    a = torch.gather(seq, 1, q.clamp(0, LW - 1))
    return torch.where((q >= 0) & (q < LW), a, 0)


def _funnel(a: torch.Tensor, b: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Limb at bit offset ``o`` (even, 0..30) of the stream ``a ++ b``."""
    return ((a << o) & MASK32) | (b >> (32 - o))


def extract_window(seq: torch.Tensor, start: torch.Tensor, width: int):
    """Left-aligned packed window of ``width`` bases from per-row ``start``:
    (N, limbs_for(width)) limbs, bits beyond ``2 * width`` zero."""
    OW = limbs_for(width)
    start = start.to(torch.int64)
    q = (start // BASES_PER_LIMB)[:, None] \
        + torch.arange(OW, device=seq.device)[None, :]
    o = (2 * (start % BASES_PER_LIMB))[:, None]
    limb = _funnel(_limb_lookup(seq, q), _limb_lookup(seq, q + 1), o)
    rem = width - BASES_PER_LIMB * (OW - 1)
    if rem < BASES_PER_LIMB:
        limb[:, OW - 1] &= (MASK32 << (32 - 2 * rem)) & MASK32
    return limb


def concat(seq_a, len_a, seq_b, len_b, skip, out_limbs: int):
    """Per-row ``a ++ b[skip:]`` on packed streams (zero-beyond-length
    invariant in, and out). Returns (seq (N, out_limbs), total length)."""
    N = seq_a.shape[0]
    total = len_a + len_b - skip
    base0 = BASES_PER_LIMB * torch.arange(out_limbs, device=seq_a.device)[None, :]
    pa = _limb_lookup(seq_a, (base0 // BASES_PER_LIMB).expand(N, out_limbs))
    la = len_a.to(torch.int64)[:, None]
    # stream b[skip:] placed at output base len_a
    bpos = (base0 - la).clamp(min=0) + skip.to(torch.int64)[:, None]
    q = bpos // BASES_PER_LIMB
    pb = _funnel(_limb_lookup(seq_b, q), _limb_lookup(seq_b, q + 1),
                 2 * (bpos % BASES_PER_LIMB))
    pb = pb >> (2 * (la - base0).clamp(0, BASES_PER_LIMB))
    valid_bases = (total.to(torch.int64)[:, None] - base0) \
        .clamp(0, BASES_PER_LIMB)
    tail_mask = (MASK32 << (32 - 2 * valid_bases)) & MASK32
    return (pa | pb) & tail_mask, total


def keys_from_windows(win: torch.Tensor, live: torch.Tensor,
                      sub: int) -> torch.Tensor:
    """Group keys from left-aligned ``sub``-base windows (``(N,
    limbs_for(sub))`` limbs). Up to 30 bases (k <= 31) a key is one int64,
    the right-aligned 2 * sub-bit integer, and a dead row's key
    :func:`bitpack.group_sentinel`; above, the key is the limb row itself
    and a dead row's all-ones limbs, as the JAX package keys rows. Either
    way dead rows order as the JAX all-ones limbs do."""
    if sub > 30:
        return torch.where(live[:, None], win, MASK32)
    if win.shape[1] == 1:
        key = win[:, 0] >> (32 - 2 * sub)
    else:
        key = (win[:, 0] << (2 * sub - 32)) | (win[:, 1] >> (64 - 2 * sub))
    return torch.where(live, key, group_sentinel(sub))


def derive_keys_packed(p: PackedRecords, marker: torch.Tensor, k: int):
    """Sort key per row: the (k-1)-base sub-k-mer at the marker end
    (:func:`keys_from_windows`)."""
    sub = k - 1
    start = torch.where(marker == 1, 0, p.length - sub).clamp(min=0)
    return keys_from_windows(extract_window(p.seq, start, sub), p.live, sub)


def group_order(key: torch.Tensor, marker: torch.Tensor):
    """Stable order by (key, marker) -> ``(order, sorted keys)``: the JAX
    round's ``lexsort((marker, limb W-1, ..., limb 0))``. The marker (< 4)
    shares the last word: an int64 key is at most 2^60, and a limb below
    2^32 leaves room, so the order is the same."""
    if key.dim() == 1:
        skey_m, order = torch.sort(key * 4 + marker, stable=True)
        return order, skey_m >> 2
    folded = torch.cat([key[:, :-1], key[:, -1:] * 4 + marker[:, None]], 1)
    order = lexsort_rows(folded)
    return order, key[order]


class Pairing(NamedTuple):
    """The merges of one round, in sorted row space: row ``fwd[i]`` takes
    ``refl ++ fwd[k-1:]`` from row ``refl[i]`` with the new end attrs."""
    fwd: torch.Tensor        # (M,) sorted positions of merging forward rows
    refl: torch.Tensor       # (M,) their reflected partners
    new_left: torch.Tensor   # (M,) int32
    new_right: torch.Tensor  # (M,) int32
    absorbed: torch.Tensor   # (N,) bool: sorted rows that die


def pair_sorted(skey, smarker, slive, sleft, sright, slen, sub: int
                ) -> Pairing:
    """In each key segment of the sorted rows the first live forward row
    and the first live reflected row merge if the gate passes
    (``ReflexivDSMain.java:3070-3086``, ``:3237-3318``)."""
    N = slen.shape[0]
    _is_start, seg = segments(skey)
    idx = torch.arange(N, device=slen.device)
    fwd_idx = first_per_segment(seg, slive & (smarker == 1), N)
    refl_idx = first_per_segment(seg, slive & (smarker == 2), N)
    has_pair = (fwd_idx < N) & (refl_idx < N)
    f = fwd_idx.clamp(max=N - 1)
    r = refl_idx.clamp(max=N - 1)
    gate = merge_gate(sleft[f], sright[f], sleft[r], sright[r],
                      slen[f] - sub, slen[r] - sub)
    merge = has_pair & gate.merge
    rows = torch.nonzero(merge & (idx == fwd_idx)).squeeze(1)
    return Pairing(rows, r[rows], gate.new_left[rows], gate.new_right[rows],
                   merge & (idx == refl_idx))


def draw_markers_packed(p: PackedRecords, round_seed: int) -> torch.Tensor:
    """Orientation draw: a hash of the first/last 16 bases, the length and
    a per-round salt (``packed.draw_markers_packed``); 1 or 2, 0 if dead."""
    n16 = min(16, p.base_capacity)
    head = extract_window(p.seq, torch.zeros_like(p.length), n16)[:, 0]
    tail = extract_window(p.seq, (p.length - n16).clamp(min=0), n16)[:, 0]
    if n16 < BASES_PER_LIMB:
        head = head >> (32 - 2 * n16)
        tail = tail >> (32 - 2 * n16)
    salt = ((round_seed & MASK32) * 0x9E3779B9) & MASK32
    h = mix32(head ^ (((tail << 16) & MASK32) | (tail >> 16))
              ^ p.length.to(torch.int64) ^ salt)
    return torch.where(p.live, 1 + (h & 1).to(torch.int32), 0).to(torch.int32)


def compact_packed(p, new_cap: int):
    """Live rows first, in row order, cut to ``new_cap`` rows; any pool of
    row tensors with a ``live`` field (the reference's ``coalesce``)."""
    take = live_first_order(p.live)[:new_cap]
    return type(p)(*(t[take] for t in p))


def park_finished_rows(p: PackedRecords, fin: torch.Tensor,
                       parked: List[PackedRecords]) -> PackedRecords:
    """Move rows flagged by ``fin`` out of the active pool into ``parked``
    (one all-live :class:`PackedRecords` batch per call, as wide as its
    longest row, kept on the device); returns the pool with those rows
    dead."""
    idx = torch.nonzero(fin).squeeze(1)
    if idx.numel():
        len_b = p.length[idx]
        lim = limbs_for(int(len_b.max()))
        parked.append(PackedRecords(
            p.seq[idx, :lim], len_b, p.left[idx], p.right[idx],
            torch.ones(idx.numel(), dtype=torch.bool, device=idx.device)))
    return p._replace(live=p.live & ~fin)


def grow_packed(p: PackedRecords, new_bases: int) -> PackedRecords:
    pad = limbs_for(new_bases) - p.limb_capacity
    if pad <= 0:
        return p
    return p._replace(seq=F.pad(p.seq, (0, pad)))


def finished_from_keys(head: torch.Tensor, tail: torch.Tensor,
                       live: torch.Tensor) -> torch.Tensor:
    """Live rows with no potential partner at either end, from their head
    and tail group keys (:func:`keys_from_windows`): no other live row's
    opposite-end key equals either of theirs."""
    N = live.shape[0]
    keys = torch.cat([head, tail])
    is_tail = torch.cat([torch.zeros_like(live), torch.ones_like(live)])
    live2 = torch.cat([live, live])
    order = lexsort_rows(keys)
    skey = keys[order]
    stail, slive = is_tail[order], live2[order]
    _is_start, seg = segments(skey)
    n_heads = segment_sum((slive & ~stail).to(torch.int64), seg, 2 * N)[seg]
    n_tails = segment_sum((slive & stail).to(torch.int64), seg, 2 * N)[seg]
    partnered = torch.empty(2 * N, dtype=torch.bool, device=live.device)
    partnered[order] = torch.where(stail, n_heads > 0, n_tails > 0)
    return live & ~partnered[:N] & ~partnered[N:]


def finished_mask_packed(p: PackedRecords, k: int) -> torch.Tensor:
    """Live rows with no potential partner at either end
    (``packed._finished_mask_packed``, its non-scatter-free form)."""
    ones = torch.ones(p.capacity, dtype=torch.int32, device=p.seq.device)
    return finished_from_keys(derive_keys_packed(p, ones, k),
                              derive_keys_packed(p, 2 * ones, k), p.live)


def extension_round_packed(p: PackedRecords, round_seed: int, *, k: int):
    """One sort -> join round. Returns ``(records, live_n, need)``, the
    last two as 0-dim tensors: the live count and the base capacity the
    next round's longest merge may need.

    Rows are sorted stably by (sub-k-mer key, marker); in each key segment
    the first live forward row and the first live reflected row merge if
    the gate passes (``ReflexivDSMain.java:3070-3086``, ``:3237-3318``):
    the forward row takes ``refl ++ fwd[k-1:]`` and the reflected row dies.
    """
    N, LW = p.seq.shape
    sub = k - 1
    marker = draw_markers_packed(p, round_seed)
    order, skey = group_order(derive_keys_packed(p, marker, k), marker)
    sseq, slen = p.seq[order], p.length[order]
    sleft, sright, slive = p.left[order], p.right[order], p.live[order]
    pairing = pair_sorted(skey, marker[order], slive, sleft, sright, slen,
                          sub)

    # the JAX round builds the concatenation for every row and selects the
    # merging ones; building it for those rows only gives the same records
    rows, rr = pairing.fwd, pairing.refl
    merged_seq, new_len = concat(
        sseq[rr], slen[rr], sseq[rows], slen[rows],
        torch.full_like(rows, sub), LW)
    out = PackedRecords(
        sseq.index_copy(0, rows, merged_seq),
        slen.index_copy(0, rows, new_len.to(torch.int32)),
        sleft.index_copy(0, rows, pairing.new_left),
        sright.index_copy(0, rows, pairing.new_right),
        slive & ~pairing.absorbed)

    live_n = out.live.sum()
    top2 = torch.topk(torch.where(out.live, out.length, 0), min(2, N)).values
    need = top2.sum() - sub
    return out, live_n, need
