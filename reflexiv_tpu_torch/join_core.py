"""Merge gate and segment primitives of the extension round (``reflexiv_tpu.join_core``).

The reference's blocked/extendable merge gate, fixed-k form
(``ReflexivDSMain.java:3070-3086``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class GateResult(NamedTuple):
    merge: torch.Tensor      # gate passes (before any extra conditions)
    bubble: torch.Tensor     # bubble distance (-1 = unconstrained merge)
    new_left: torch.Tensor
    new_right: torch.Tensor


def merge_gate(f_left, f_right, r_left, r_right, f_ext, r_ext) -> GateResult:
    """The four-case merge gate + fixed-k attribute propagation
    (``join_core.merge_gate`` with ``extra=None``)."""
    c1 = (f_left < 0) & (r_right < 0)
    c2 = (f_left >= 0) & (r_right >= 0)
    c3 = ~c1 & ~c2 & (f_left >= 0) & (f_left - r_ext >= 0)
    c4 = ~c1 & ~c2 & ~c3 & (r_right >= 0) & (r_right - f_ext >= 0)
    merge = c1 | c2 | c3 | c4
    bubble = torch.where(
        c1 | c2, -1, torch.where(c3, f_left - r_ext, r_right - f_ext))
    new_left = torch.where(
        bubble < 0, r_left, torch.where(f_left > 0, bubble, r_left))
    new_right = torch.where(
        bubble < 0, f_right, torch.where(f_left > 0, f_right, bubble))
    return GateResult(merge, bubble, new_left.to(torch.int32),
                      new_right.to(torch.int32))


def segments(skey: torch.Tensor):
    """Sorted ``(N,)`` keys or ``(N, W)`` word rows -> ``(is_start, seg)``:
    equal-key runs as segments (a row starts one where any word differs)."""
    is_start = torch.ones(skey.shape[0], dtype=torch.bool, device=skey.device)
    diff = skey[1:] != skey[:-1]
    is_start[1:] = diff.any(-1) if skey.dim() == 2 else diff
    seg = torch.cumsum(is_start, 0) - 1
    return is_start, seg


def lexsort_rows(keys: torch.Tensor, secondary: torch.Tensor = None
                 ) -> torch.Tensor:
    """Stable order by ``keys`` (``(N,)`` or ``(N, W)`` rows compared word
    by word), then by ``secondary``: ``jnp.lexsort`` of
    ``(secondary, word W-1, ..., word 0)``, ties keeping row order. Chained
    stable sorts, least significant first."""
    cols = [keys] if keys.dim() == 1 else \
        [keys[:, w] for w in range(keys.shape[1] - 1, -1, -1)]
    if secondary is not None:
        cols = [secondary] + cols
    order = torch.sort(cols[0], stable=True).indices
    for col in cols[1:]:
        order = order[torch.sort(col[order], stable=True).indices]
    return order


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int):
    return torch.zeros(n, dtype=values.dtype, device=values.device) \
        .scatter_add_(0, seg, values)


def first_per_segment(seg: torch.Tensor, cond: torch.Tensor, n: int):
    """Index of the first row satisfying ``cond`` in each row's segment
    (n when absent)."""
    idx = torch.arange(n, dtype=torch.int64, device=seg.device)
    first = torch.full((n,), n, dtype=torch.int64, device=seg.device)
    first.scatter_reduce_(0, seg, torch.where(cond, idx, n), "amin")
    return first[seg]
