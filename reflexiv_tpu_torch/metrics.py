"""Run metrics: stage timers + counters with a JSON dump.

The reference's only in-code tracing is ``InfoDumper``'s timestamped stdout
lines (``util/InfoDumper.java:43-154``) plus Spark's event log; here stage
wall times and record/k-mer counters are first-class and written to
``<outfile>/metrics.json`` so production runs are observable without a
Spark UI. Used by the CLI (every command) and the hot pipeline
stages; zero overhead when never queried (plain dict + perf_counter).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import OrderedDict
from typing import Dict, Iterator

log = logging.getLogger("reflexiv_tpu_torch")


class Metrics:
    """Per-run registry: ``stage()`` context timers (accumulating, nestable)
    and monotonic counters."""

    def __init__(self) -> None:
        self.timers: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timers[name] = self.timers.get(name, 0.0) + dt
            log.info("stage %s: %.2f s", name, dt)

    def lap_start(self) -> None:
        """Reset the lap clock (start of a staged pipeline)."""
        self._lap_t = time.perf_counter()

    def lap(self, name: str) -> None:
        """Accumulate the time since the previous ``lap``/``lap_start`` under
        ``name`` — brackets sequential pipeline stages without re-indenting
        them into context managers."""
        now = time.perf_counter()
        last = getattr(self, "_lap_t", self._t0)
        self.timers[name] = self.timers.get(name, 0.0) + (now - last)
        self._lap_t = now
        log.info("stage %s: %.2f s", name, now - last)

    def add(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def add_time(self, name: str, dt: float) -> None:
        """Accumulate a measured interval under ``name`` — the host-vs-
        device sub-timers inside a stage (ingest wall, device dispatch
        wall, input-stall wall) that the stage() bracket can't see."""
        self.timers[name] = self.timers.get(name, 0.0) + dt

    def set(self, name: str, n: int) -> None:
        self.counts[name] = int(n)

    def snapshot(self) -> Dict:
        return {
            "wall_s": round(time.perf_counter() - self._t0, 3),
            "stages_s": {k: round(v, 3) for k, v in self.timers.items()},
            "counters": dict(self.counts),
        }

    def write(self, out_dir: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "metrics.json")
        with open(path, "w") as fh:
            json.dump(self.snapshot(), fh, indent=1, sort_keys=False)
        return path


_current = Metrics()


def current() -> Metrics:
    return _current


def reset() -> Metrics:
    """Fresh registry (one per CLI command / API run)."""
    global _current
    _current = Metrics()
    return _current
