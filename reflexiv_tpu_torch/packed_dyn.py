"""Mixed-k summary join of ``meta``'s extension rounds, on the device
(``reflexiv_tpu.packed_dyn.pdyn_round_indexed``).

A round decides every merge from fixed-width row summaries: the
``max_sub``-base head and tail windows, the first/last 16 bases (the
orientation draw's input), length, ``subk`` and the two end attrs. Limbs
are int64 tensors holding uint32 values (``reflexiv_tpu_torch.packed``'s
convention). The round draws each row's marker, groups rows by the
(kmin-1)-base window at the marker end in one stable sort of (group key,
marker), so rows keep their pool order within a group, and pairs the first
forward row with the first reflected row of each group: a merge needs the
reflected row's sub-k-mer to prefix the forward row's
(``dynamicSubKmerComparator``, ``ReflexivDSDynamicKmerIteration.java
:740-768``) and the mixed-k gate (``join_core.merge_gate`` with ``extra``).

Where the JAX round broadcasts the partners' fields with segmented scans
(``join_core.segmented_fill``, a TPU workaround), this one gathers them at
per-group positions.

The mesh loop's pool is the dense form (``packed_dyn.PackedDynRecords``,
``_pdyn_round_impl``) held as a :class:`FlatPool`: the live rows only, in
pool order, each in its own ``limbs_for(length)`` limbs, back to back.
A row's width changes no result, so a megabase contig costs its own
limbs and not the widest row's times every row, as the JAX pool's does.
:func:`pdyn_extension_round_fused` is the JAX lexsort round on it: the
rows come out in sorted order, a merged row at its forward row's place
and its reflected partner gone, which is the JAX round's output after
the stable live-first compaction. The splice is :func:`flat_concat` on
the device.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from .bitpack import MASK32, mix32
from .join_core import lexsort_rows, merge_gate
from .packed import _funnel

BASES_PER_LIMB = 16


def limbs_for(n_bases: int) -> int:
    return (n_bases + BASES_PER_LIMB - 1) // BASES_PER_LIMB


def _limb_mask(nbases: torch.Tensor, W: int) -> torch.Tensor:
    """(N, W) masks covering the first ``nbases`` bases of each row."""
    m = torch.arange(W, device=nbases.device)[None, :]
    bits = (2 * (nbases.to(torch.int64)[:, None] - BASES_PER_LIMB * m)) \
        .clamp(0, 32)
    return (MASK32 << (32 - bits)) & MASK32


def masked_prefix_eq(a: torch.Tensor, b: torch.Tensor,
                     nbases: torch.Tensor) -> torch.Tensor:
    """Rows of two left-aligned packed windows equal on their first
    ``nbases`` bases."""
    return (((a ^ b) & _limb_mask(nbases, a.shape[1])) == 0).all(1)


def draw_markers(head16: torch.Tensor, tail16: torch.Tensor,
                 length: torch.Tensor, round_seed: int) -> torch.Tensor:
    """Orientation draw, 1 (forward) or 2 (reflected): a hash of the first
    and last 16 bases, the length and a per-round salt
    (``packed_dyn.draw_markers_pdyn``)."""
    salt = ((round_seed & MASK32) * 0x9E3779B9) & MASK32
    rot = ((tail16 << 16) & MASK32) | (tail16 >> 16)
    h = mix32(head16 ^ rot ^ length.to(torch.int64) ^ salt)
    return 1 + (h & 1)


def _group_order(keys: torch.Tensor, marker: torch.Tensor, gw: int):
    """Stable order by (group key, marker) -> (order, sorted group keys).
    Up to 30 bases the key and the marker share one int64; wider keys sort
    limb by limb."""
    if gw <= 30:
        if keys.shape[1] == 1:
            key = keys[:, 0] >> (32 - 2 * gw)
        else:
            key = (keys[:, 0] << (2 * gw - 32)) | (keys[:, 1] >> (64 - 2 * gw))
        skey, order = torch.sort(key * 4 + marker, stable=True)
        return order, skey >> 2
    order = lexsort_rows(keys, marker)
    return order, keys[order]


def _count_before(a: torch.Tensor, q: torch.Tensor, *,
                  ties_first: bool) -> torch.Tensor:
    """Per row of ``q``, how many rows of ``a`` precede it in limb-wise
    lexicographic order: those <= it (``ties_first``, numpy's
    ``searchsorted(..., side="right")``) or < it (``side="left"``). One
    stable sort of both sets, the set tag folded into the last limb."""
    tag_a = 0 if ties_first else 1
    rows = torch.cat([a, q])
    rows = torch.cat([rows[:, :-1], rows[:, -1:] * 2 + torch.cat([
        torch.full((len(a), 1), tag_a, dtype=rows.dtype, device=rows.device),
        torch.full((len(q), 1), 1 - tag_a, dtype=rows.dtype,
                   device=rows.device)])], 1)
    order = lexsort_rows(rows)
    is_a = order < len(a)
    before = torch.cumsum(is_a, 0)
    out = torch.empty(len(q), dtype=torch.int64, device=q.device)
    out[order[~is_a] - len(a)] = before[~is_a]
    return out


def finished_mask(head: torch.Tensor, tailw: torch.Tensor,
                  subk: torch.Tensor, max_sub: int) -> torch.Tensor:
    """Exact extendability census from the summaries
    (``dynamic._finished_mask_from_summ``): a row is finished when no tail
    interval ``[t & mask, t | ~mask]`` of width ``subk`` meets its head
    interval and no head interval meets its tail. Interval hits are counted
    with :func:`_count_before` where numpy searches sorted byte strings."""
    W = limbs_for(max_sub)
    mask = _limb_mask(subk, W)
    h_lo, h_hi = head[:, :W] & mask, head[:, :W] | (MASK32 ^ mask)
    t_lo, t_hi = tailw[:, :W] & mask, tailw[:, :W] | (MASK32 ^ mask)
    head_hits = _count_before(t_lo, h_hi, ties_first=True) \
        - _count_before(t_hi, h_lo, ties_first=False)
    tail_hits = _count_before(h_lo, t_hi, ties_first=True) \
        - _count_before(h_hi, t_lo, ties_first=False)
    return (head_hits == 0) & (tail_hits == 0)


def _join(keys: torch.Tensor, marker: torch.Tensor, gw: int,
          length: torch.Tensor, subk: torch.Tensor, left: torch.Tensor,
          right: torch.Tensor, head_of: Callable, tail_of: Callable,
          unique_only: bool):
    """The merges of one round over N rows with their group keys and
    markers: ``(order, fwd, refl, new_left, new_right)``, ``order`` the
    stable (group key, marker) order and one merge per entry, in group
    order. ``head_of(rows)``/``tail_of(rows)`` give those rows'
    ``max_sub``-base head and tail windows."""
    N = length.shape[0]
    dev = length.device
    order, skey = _group_order(keys, marker, gw)
    smarker = marker[order]

    is_start = torch.ones(N, dtype=torch.bool, device=dev)
    diff = skey[1:] != skey[:-1]
    is_start[1:] = diff.any(1) if skey.dim() == 2 else diff
    starts = torch.nonzero(is_start).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([N])])
    # forward rows lead their group (marker 1 sorts before 2)
    n_fwd_before = torch.cumsum(smarker == 1, 0)
    n_fwd = n_fwd_before[ends - 1] - torch.where(
        starts > 0, n_fwd_before[(starts - 1).clamp(min=0)], 0)
    n_refl = ends - starts - n_fwd
    pair = (n_fwd > 0) & (n_refl > 0)
    if unique_only:
        pair &= (n_fwd == 1) & (n_refl == 1)
    f = order[starts[pair]]
    r = order[(starts + n_fwd)[pair]]

    f_len, f_sub = length[f].to(torch.int64), subk[f].to(torch.int64)
    r_len, r_sub = length[r].to(torch.int64), subk[r].to(torch.int64)
    prefix_ok = masked_prefix_eq(head_of(f), tail_of(r), r_sub) \
        & (r_sub <= f_sub)
    gate = merge_gate(left[f].to(torch.int64), right[f].to(torch.int64),
                      left[r].to(torch.int64), right[r].to(torch.int64),
                      f_len - f_sub, r_len - r_sub, extra=f_sub - r_sub)
    merge = prefix_ok & gate.merge
    return (order, f[merge], r[merge], gate.new_left[merge],
            gate.new_right[merge])


def _marker_keys(head16, tail16, key_win, length, round_seed: int, gw: int):
    """Markers and (kmin-1)-base group keys: ``key_win(marker)`` is each
    row's window at its marker end, masked to ``gw`` bases here."""
    marker = draw_markers(head16, tail16, length, round_seed)
    keys = key_win(marker)
    Wp = limbs_for(gw)
    rem = gw - BASES_PER_LIMB * (Wp - 1)
    if rem < BASES_PER_LIMB:
        keys[:, Wp - 1] &= (MASK32 << (32 - 2 * rem)) & MASK32
    return marker, keys


def pdyn_round_indexed(
    head: torch.Tensor, tailw: torch.Tensor, head16: torch.Tensor,
    tail16: torch.Tensor, length: torch.Tensor, subk: torch.Tensor,
    left: torch.Tensor, right: torch.Tensor, round_seed: int, *,
    kmin: int, max_sub: int, unique_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One mixed-k join round over the summaries of N live rows.

    ``head``/``tailw`` are (N, limbs_for(max_sub)) limbs; the other inputs
    (N,). Returns ``(fwd, refl, new_left, new_right)``, one entry per merge
    in ascending ``fwd`` row: row ``fwd`` becomes ``refl ++ fwd[subk of
    refl:]`` with the new attrs, and row ``refl`` is absorbed. With
    ``unique_only`` a group merges only when it holds exactly one forward
    and one reflected row."""
    gw = kmin - 1
    Wp = limbs_for(gw)
    marker, keys = _marker_keys(
        head16, tail16,
        lambda m: torch.where((m == 1)[:, None], head[:, :Wp], tailw[:, :Wp]),
        length, round_seed, gw)
    _order, f, r, new_left, new_right = _join(
        keys, marker, gw, length, subk, left, right, head.__getitem__,
        tailw.__getitem__, unique_only)
    f, by_f = torch.sort(f)
    return f, r[by_f], new_left[by_f], new_right[by_f]


# ---------------------------------------------------------------------------
# the dense pool of the mesh loop
# ---------------------------------------------------------------------------

class FlatPool(NamedTuple):
    """Live mixed-k rows in pool order (``packed_dyn.PackedDynRecords``'
    live rows): row i holds ``limbs_for(length[i])`` limbs of ``limbs``,
    the rows back to back, each left-aligned with zeros past its length."""

    limbs: torch.Tensor   # (T,) int64 limbs in [0, 2^32)
    length: torch.Tensor  # (N,) int32
    subk: torch.Tensor    # (N,) int32, sub-k-mer (join overlap) length
    left: torch.Tensor    # (N,) int32
    right: torch.Tensor   # (N,) int32

    @property
    def n(self) -> int:
        return self.length.shape[0]

    def to(self, device) -> "FlatPool":
        return FlatPool(*(_to(t, device) for t in self))


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``; asynchronous only onto a card (an asynchronous
    copy to the host may still be running when the host reads it)."""
    return t.to(device, non_blocking=torch.device(device).type == "cuda")


def empty_pool(device) -> FlatPool:
    z = torch.zeros(0, dtype=torch.int32, device=device)
    return FlatPool(torch.zeros(0, dtype=torch.int64, device=device),
                    z, z, z, z)


def row_offsets(length: torch.Tensor):
    """Each row's first limb and limb count."""
    nl = (length.to(torch.int64) + BASES_PER_LIMB - 1) // BASES_PER_LIMB
    return torch.cumsum(nl, 0) - nl, nl


def _lookup(limbs: torch.Tensor, off: torch.Tensor, nl: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """Limb ``q`` of the row at ``off`` with ``nl`` limbs, 0 past it."""
    if limbs.numel() == 0:
        return torch.zeros_like(q)
    ok = (q >= 0) & (q < nl)
    return torch.where(ok, limbs[(off + q).clamp(0, limbs.numel() - 1)], 0)


def window(limbs: torch.Tensor, off: torch.Tensor, nl: torch.Tensor,
           start: torch.Tensor, width: int) -> torch.Tensor:
    """Left-aligned window of ``width`` bases from base ``start`` of each
    row ``(off, nl)``: (N, limbs_for(width)) limbs, zeros past the row and
    past ``2 * width`` bits (``packed.extract_window``)."""
    OW = limbs_for(width)
    start = start.to(torch.int64)
    q = (start // BASES_PER_LIMB)[:, None] \
        + torch.arange(OW + 1, device=limbs.device)[None, :]
    v = _lookup(limbs, off[:, None], nl[:, None], q)
    out = _funnel(v[:, :-1], v[:, 1:], (2 * (start % BASES_PER_LIMB))[:, None])
    rem = width - BASES_PER_LIMB * (OW - 1)
    if rem < BASES_PER_LIMB:
        out[:, OW - 1] &= (MASK32 << (32 - 2 * rem)) & MASK32
    return out


def pool_window(p: FlatPool, start: torch.Tensor, width: int,
                rows: torch.Tensor = None) -> torch.Tensor:
    """:func:`window` over every row of ``p``, or over ``rows``."""
    off, nl = row_offsets(p.length)
    if rows is not None:
        off, nl = off[rows], nl[rows]
    return window(p.limbs, off, nl, start, width)


def take(p: FlatPool, idx: torch.Tensor) -> FlatPool:
    """Rows ``idx`` of ``p``, in that order."""
    off, nl = row_offsets(p.length)
    o, n = off[idx], nl[idx]
    new_off = torch.cumsum(n, 0) - n
    total = int(n.sum())
    src = torch.repeat_interleave(o - new_off, n, output_size=total) \
        + torch.arange(total, device=p.limbs.device)
    return FlatPool(p.limbs[src], *(t[idx] for t in p[1:]))


def cat(pools: List[FlatPool], device) -> FlatPool:
    """Rows of every pool in turn, on ``device``."""
    if not pools:
        return empty_pool(device)
    return FlatPool(*(torch.cat([_to(t, device) for t in col])
                      for col in zip(*pools)))


def split(p: FlatPool, sizes: List[int]) -> List[FlatPool]:
    """Consecutive row ranges of ``sizes`` rows (they sum to ``p.n``)."""
    _off, nl = row_offsets(p.length)
    bounds = torch.tensor([0] + list(itertools.accumulate(sizes)),
                          device=nl.device)
    cs = torch.cat([nl.new_zeros(1), torch.cumsum(nl, 0)])[bounds].tolist()
    cols = [p.limbs.split([b - a for a, b in zip(cs, cs[1:])])] \
        + [t.split(sizes) for t in p[1:]]
    return [FlatPool(*c) for c in zip(*cols)]


def from_dense(seq, length, subk, left, right) -> FlatPool:
    """Dense (N, W) limb rows, zeros past each length (a tensor, or a
    numpy uint32 matrix and columns), -> a pool on the same device."""
    if isinstance(seq, np.ndarray):
        seq = torch.from_numpy(np.ascontiguousarray(seq, np.int64))
    cols = [torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t)
            .to(seq.device, torch.int32) for t in (length, subk, left, right)]
    nl = (cols[0].to(torch.int64) + BASES_PER_LIMB - 1) // BASES_PER_LIMB
    mask = torch.arange(seq.shape[1], device=seq.device)[None, :] \
        < nl[:, None]
    return FlatPool(seq.to(torch.int64)[mask], *cols)


def from_groups(groups) -> FlatPool:
    """Width-class groups ``[(seq, length, subk, left, right), ...]`` (numpy)
    -> one host pool, the groups' rows in turn."""
    return cat([from_dense(*g) for g in groups], "cpu")


def to_dense(p: FlatPool, width: int = 0) -> torch.Tensor:
    """(N, width) limb rows, ``width`` the longest row's limbs by default."""
    W = width or max(limbs_for(int(p.length.max())) if p.n else 1, 1)
    return pool_window(p, torch.zeros_like(p.length), W * BASES_PER_LIMB)


def flat_concat(p: FlatPool, a_rows: torch.Tensor, a_len: torch.Tensor,
                b_rows: torch.Tensor, b_len: torch.Tensor,
                skip: torch.Tensor):
    """Per pair, the first ``a_len`` bases of row ``a_rows`` then bases
    ``[skip, b_len)`` of row ``b_rows`` (``packed.concat`` over flat rows;
    ``a_len = 0`` cuts a substring). Returns the new rows' limbs, back to
    back, and their lengths."""
    off, nl = row_offsets(p.length)
    la, lb = a_len.to(torch.int64), b_len.to(torch.int64)
    skip = skip.to(torch.int64)
    total = la + lb - skip
    nout = (total + BASES_PER_LIMB - 1) // BASES_PER_LIMB
    T = int(nout.sum())
    dev = p.limbs.device
    row = torch.repeat_interleave(
        torch.arange(nout.numel(), device=dev), nout, output_size=T)
    m = torch.arange(T, device=dev) - (torch.cumsum(nout, 0) - nout)[row]
    base0 = BASES_PER_LIMB * m
    la_r = la[row]
    # bits past a_len are cut by the shifted b stream's placement below
    pa = _lookup(p.limbs, off[a_rows][row], nl[a_rows][row], m)
    pa &= (MASK32 << (32 - 2 * (la_r - base0).clamp(0, BASES_PER_LIMB))) \
        & MASK32
    bpos = (base0 - la_r).clamp(min=0) + skip[row]
    q = bpos // BASES_PER_LIMB
    ob, nb = off[b_rows][row], nl[b_rows][row]
    pb = _funnel(_lookup(p.limbs, ob, nb, q), _lookup(p.limbs, ob, nb, q + 1),
                 2 * (bpos % BASES_PER_LIMB))
    pb = pb >> (2 * (la_r - base0).clamp(0, BASES_PER_LIMB))
    valid = (total[row] - base0).clamp(0, BASES_PER_LIMB)
    return (pa | pb) & ((MASK32 << (32 - 2 * valid)) & MASK32), \
        total.to(torch.int32)


def summaries(p: FlatPool, max_sub: int):
    """``(head, tail)``: each row's ``max_sub``-base windows at its start
    and at ``length - subk``, as the census and the prefix test read
    them."""
    off, nl = row_offsets(p.length)
    zero = torch.zeros_like(p.length)
    return (window(p.limbs, off, nl, zero, max_sub),
            window(p.limbs, off, nl, (p.length - p.subk).clamp(min=0),
                   max_sub))


def group_keys(p: FlatPool, round_seed: int, kmin: int):
    """Each row's marker and (kmin-1)-base group key window, as
    ``draw_markers_pdyn`` and the round draw and cut them (the key the
    mesh routes a row by)."""
    off, nl = row_offsets(p.length)
    length = p.length
    zero = torch.zeros_like(length)
    head16 = window(p.limbs, off, nl, zero, 16)[:, 0]
    tail16 = window(p.limbs, off, nl, (length - 16).clamp(min=0), 16)[:, 0]
    gw = kmin - 1
    return _marker_keys(
        head16, tail16,
        lambda m: window(p.limbs, off, nl, torch.where(
            m == 1, 0, length - p.subk).clamp(min=0), gw),
        length, round_seed, gw)


def pdyn_extension_round_fused(p: FlatPool, round_seed: int, *, kmin: int,
                               max_sub: int, unique_only: bool = False):
    """One dense mixed-k round (``packed_dyn.pdyn_extension_round_fused``,
    its lexsort form): rows sorted stably by (group key, marker); in each
    group the first forward and the first reflected row merge when the
    reflected sub-k-mer prefixes the forward one and the gate passes.
    Returns ``(pool, live_n, need)``: the rows in sorted order, the merged
    row at its forward row's place and the reflected row gone; the row
    count; and the two longest rows' total length."""
    N = p.n
    if N == 0:
        return p, 0, 0
    gw = kmin - 1
    marker, keys = group_keys(p, round_seed, kmin)
    off, nl = row_offsets(p.length)
    zero = torch.zeros_like(p.length)
    order, f, r, new_left, new_right = _join(
        keys, marker, gw, p.length, p.subk, p.left, p.right,
        lambda i: window(p.limbs, off[i], nl[i], zero[i], max_sub),
        lambda i: window(p.limbs, off[i], nl[i],
                         (p.length[i] - p.subk[i]).clamp(min=0), max_sub),
        unique_only)
    M = f.numel()
    merged, total = flat_concat(p, r, p.length[r], f, p.length[f], p.subk[r])
    ext = FlatPool(torch.cat([p.limbs, merged]),
                   torch.cat([p.length, total]),
                   torch.cat([p.subk, p.subk[f]]),
                   torch.cat([p.left, new_left]),
                   torch.cat([p.right, new_right]))
    gone = torch.zeros(N, dtype=torch.bool, device=p.length.device)
    gone[r] = True
    src = torch.arange(N, device=p.length.device)
    src[f] = N + torch.arange(M, device=p.length.device)
    out = take(ext, src[order[~gone[order]]])
    top2 = torch.topk(out.length, min(2, out.n)).values
    return out, out.n, int(top2.sum())


def finished_mask_pdyn_exact(p: FlatPool, max_sub: int) -> torch.Tensor:
    """The exact census of a dense pool
    (``packed_dyn.finished_mask_pdyn_exact``): :func:`finished_mask` over
    the rows' head and tail windows."""
    head, tailw = summaries(p, max_sub)
    return finished_mask(head, tailw, p.subk, max_sub)


def park_finished_pdyn(p: FlatPool, fin: torch.Tensor,
                       parked: List[FlatPool]) -> FlatPool:
    """Move the rows flagged by ``fin`` into ``parked`` as one host batch
    (``packed_dyn.park_finished_pdyn``); returns the rest, in order."""
    idx = torch.nonzero(fin).squeeze(1)
    if idx.numel():
        parked.append(take(p, idx).to("cpu"))
    return take(p, torch.nonzero(~fin).squeeze(1))


def merge_parked_pdyn(p: FlatPool, parked: List[FlatPool]) -> FlatPool:
    """The pool's rows then the parked batches in order, on the host
    (``packed_dyn.merge_parked_pdyn``)."""
    return cat([p] + list(parked), "cpu")
