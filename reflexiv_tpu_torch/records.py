"""Reflexible Distributed K-mer (RDK) records as tensors (``reflexiv_tpu.records``).

A record is its full nucleotide sequence plus an explicit length and two
end attributes; marker 1 keys a record on its first k-1 bases, marker 2 on
its last k-1 (``ReflexivDSMain.java:142-167``). Tensors share a leading
capacity N with a liveness mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Attr code: values < 0 mean "end extendable, coverage-tagged" (-1-cover);
# values >= 0 mean "end blocked at distance attr" (fork survivor),
# ReflexivDSMain.java:3425-3484.
REPEAT_KILLED = -10_000_000  # both-ends marker for dropped repeat fragments
                             # (ReflexivDSMain.java:749,1711)


class Records(NamedTuple):
    """Struct-of-tensors RDK set. All tensors share leading capacity N."""

    seq: torch.Tensor      # (N, L) uint8 base codes, left-aligned
    length: torch.Tensor   # (N,) int32 — bases used in seq
    left: torch.Tensor     # (N,) int32 — left-end attr
    right: torch.Tensor    # (N,) int32 — right-end attr
    live: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.seq.shape[0]

    @property
    def seq_capacity(self) -> int:
        return self.seq.shape[1]


def live_first_order(live: torch.Tensor) -> torch.Tensor:
    """Stable permutation putting live rows first, each group in row order
    (``argsort(~live, stable=True)``)."""
    return torch.sort((~live).to(torch.int8), stable=True).indices


def compact(recs: Records, new_cap: int) -> Records:
    """Pack live rows to the front and keep the first ``new_cap`` rows (all
    rows when there are fewer): the reference's ``coalesce``
    (``ReflexivDSMain.java:313-318``)."""
    take = live_first_order(recs.live)[:new_cap]
    return Records(*(t[take] for t in recs))


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p
