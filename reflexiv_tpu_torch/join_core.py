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
    """Sorted keys -> ``(is_start, seg)``: equal-key runs as segments."""
    is_start = torch.ones_like(skey, dtype=torch.bool)
    is_start[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(is_start, 0) - 1
    return is_start, seg


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
