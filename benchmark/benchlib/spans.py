"""The program's own ranges on the profiler's clock.

While a profiler records, every stage the program times
(``reflexiv_tpu_torch.metrics.Metrics.stage``) is also a host range of
the stage's name. These are read from the main thread's host events of a
:class:`benchlib.trace.Trace` (``Trace._cpu``: ``(start, end, name)`` in
nanoseconds) and set against its merged device activity
(``Trace.busy``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def ranges(trace, name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Starts and ends of the main thread's host events named ``name``,
    clipped to the window, empty ones dropped."""
    got = [(s, e) for s, e, n in trace._cpu if n == name]
    s = np.clip(np.asarray([g[0] for g in got], np.int64), trace.t0, trace.t1)
    e = np.clip(np.asarray([g[1] for g in got], np.int64), trace.t0, trace.t1)
    keep = e > s
    return s[keep], e[keep]


def busy_within(trace, starts: np.ndarray, ends: np.ndarray) -> int:
    """Nanoseconds of device activity inside the intervals (disjoint)."""
    bs, be = trace.busy
    if len(bs) == 0 or len(starts) == 0:
        return 0
    before = np.concatenate([[0], np.cumsum(be - bs)])

    def busy_before(t):
        # busy intervals are disjoint and sorted: those starting at or
        # before t count whole, less the part of the last that is past t
        i = np.searchsorted(bs, t, side="right")
        j = np.maximum(i - 1, 0)
        part = np.minimum(t, be[j]) - bs[j]
        return np.where(i > 0, before[j] + part, 0)

    return int((busy_before(ends) - busy_before(starts)).sum())


def busy_pct(trace, name: str) -> Optional[float]:
    """Share of the ranges named ``name`` in which the card ran a kernel,
    copy or fill, in %; None without a trace or without such a range."""
    if trace is None:
        return None
    s, e = ranges(trace, name)
    total = int((e - s).sum())
    if total <= 0:
        return None
    return 100.0 * busy_within(trace, s, e) / total
