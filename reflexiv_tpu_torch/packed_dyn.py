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
"""
from __future__ import annotations

from typing import Tuple

import torch

from .bitpack import MASK32, mix32
from .join_core import lexsort_rows, merge_gate

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
    N = length.shape[0]
    dev = length.device
    gw = kmin - 1
    Wp = limbs_for(gw)
    marker = draw_markers(head16, tail16, length, round_seed)
    keys = torch.where((marker == 1)[:, None], head[:, :Wp], tailw[:, :Wp])
    rem = gw - BASES_PER_LIMB * (Wp - 1)
    if rem < BASES_PER_LIMB:
        keys[:, Wp - 1] &= (MASK32 << (32 - 2 * rem)) & MASK32
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
    prefix_ok = masked_prefix_eq(head[f], tailw[r], r_sub) & (r_sub <= f_sub)
    gate = merge_gate(left[f].to(torch.int64), right[f].to(torch.int64),
                      left[r].to(torch.int64), right[r].to(torch.int64),
                      f_len - f_sub, r_len - r_sub, extra=f_sub - r_sub)
    merge = prefix_ok & gate.merge
    f, r = f[merge], r[merge]
    f, by_f = torch.sort(f)
    return (f, r[by_f], gate.new_left[merge][by_f],
            gate.new_right[merge][by_f])
