"""What the profiler saw over the measured window, reduced to what the
metric readers and the ``breakdown`` need.

Device activity (every kernel, copy and fill the profiler records on the
card) is merged into busy intervals; the window runs from the first job's
start to the last job's end, as the benchmark's own ``bench/job`` spans
mark them on the profiler's clock. An idle gap is labelled by the job
stage it falls in (the job's span start plus its ``metrics.json`` laps in
order) and by the innermost host operation the profiler recorded across
it on the main thread.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

JOB_SPAN = "bench/job"
NAME_CHARS = 160   # a device operation's name, cut to this in the breakdown


def _events(prof):
    """The profiler's raw events (no per-event Python objects are built
    beyond these)."""
    return prof.profiler.kineto_results.events()


class Trace:
    def __init__(self, prof, job_laps: List[List[Tuple[str, float]]]):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev_start, dev_end, dev_name = [], [], []
        cpu = []
        spans = []
        for e in _events(prof):
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == cuda:
                # a span's shadow on the device timeline is no device work
                if not e.is_user_annotation() and e.name() != JOB_SPAN:
                    dev_start.append(start)
                    dev_end.append(end)
                    dev_name.append(e.name())
            elif e.name() == JOB_SPAN:
                spans.append((start, end, e.start_thread_id()))
            else:
                cpu.append((start, end, e.start_thread_id(), e.name()))
        spans.sort()
        if spans:
            self.t0, self.t1 = spans[0][0], max(s[1] for s in spans)
            main = spans[0][2]
        else:
            self.t0 = self.t1 = 0
            main = None
        self.window_s = (self.t1 - self.t0) / 1e9
        s = np.asarray(dev_start, np.int64)
        e = np.asarray(dev_end, np.int64)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        self._dev_names = [dev_name[i] for i in order]
        self._dev_dur = e - s
        # merged busy intervals, clipped to the window
        if len(s):
            reach = np.maximum.accumulate(e)
            new = np.ones(len(s), bool)
            new[1:] = s[1:] > reach[:-1]
            starts = s[new]
            ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
            starts = np.clip(starts, self.t0, self.t1)
            ends = np.clip(ends, self.t0, self.t1)
            keep = ends > starts
            self.busy = (starts[keep], ends[keep])
        else:
            self.busy = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        self.busy_s = float((self.busy[1] - self.busy[0]).sum()) / 1e9
        self._stages = self._stage_bounds(spans, job_laps)
        # outer events before the inner ones that start with them
        self._cpu = sorted((c[:2] + (c[3],) for c in cpu if c[2] == main
                            and c[1] > c[0]), key=lambda c: (c[0], -c[1]))

    # ------------------------------------------------------------ readers

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose names match ``pattern``
        (a regular expression, searched)."""
        rx = re.compile(pattern)
        by_name = self.device_time_by_name()
        return sum(t for name, t in by_name.items() if rx.search(name))

    def device_time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, d in zip(self._dev_names, self._dev_dur.tolist()):
            out[name] += d / 1e9
        return out

    # ---------------------------------------------------------- breakdown

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_time_by_name().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:NAME_CHARS], t] for n, t in ops[:top]],
                "idle_gaps": self.idle_by_label()[:top]}

    def gaps(self) -> Tuple[np.ndarray, np.ndarray]:
        """Idle intervals of the window."""
        bs, be = self.busy
        starts = np.concatenate([[self.t0], be])
        ends = np.concatenate([bs, [self.t1]])
        keep = ends > starts
        return starts[keep], ends[keep]

    def idle_by_label(self) -> List[list]:
        """``[label, seconds]`` of the idle time, by stage and host
        operation, most first."""
        gs, ge = self.gaps()
        totals: Dict[str, float] = defaultdict(float)
        if len(gs) == 0:
            return []
        mids = (gs + ge) // 2
        ops = self._innermost(mids)
        stages = self._stage_at(mids)
        for st, op, d in zip(stages, ops, (ge - gs).tolist()):
            totals[f"{st} | {op}"] += d / 1e9
        return [[k, v] for k, v in sorted(totals.items(),
                                          key=lambda kv: -kv[1])]

    @staticmethod
    def _stage_bounds(spans, job_laps):
        """``(start, end, stage)`` on the profiler's clock for each lap of
        each job: laps run in order from the job's start."""
        out = []
        for (start, _end, _tid), laps in zip(spans, job_laps):
            at = start
            for name, seconds in laps:
                out.append((at, at + int(seconds * 1e9), name))
                at += int(seconds * 1e9)
        return out

    def _stage_at(self, times: np.ndarray) -> List[str]:
        if not self._stages:
            return ["window"] * len(times)
        st = np.asarray([s[0] for s in self._stages], np.int64)
        en = np.asarray([s[1] for s in self._stages], np.int64)
        i = np.searchsorted(st, times, side="right") - 1
        out = []
        for t, j in zip(times.tolist(), i.tolist()):
            out.append(self._stages[j][2] if j >= 0 and t < en[j]
                       else "between stages")
        return out

    def _innermost(self, times: np.ndarray) -> List[str]:
        """Name of the innermost main-thread host event covering each
        time, ``no traced op`` where none does."""
        cpu = self._cpu
        if not cpu:
            return ["no traced op"] * len(times)
        st = np.asarray([c[0] for c in cpu], np.int64)
        parent = np.full(len(cpu), -1, np.int64)
        stack: List[int] = []
        for i, (s, e, _n) in enumerate(cpu):
            while stack and cpu[stack[-1]][1] <= s:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
        out = []
        at = np.searchsorted(st, times, side="right") - 1
        for t, j in zip(times.tolist(), at.tolist()):
            while j >= 0 and cpu[j][1] <= t:
                j = int(parent[j])
            out.append(cpu[j][2] if j >= 0 else "no traced op")
        return out


def job_laps(metrics_json: Optional[dict], stages: List[str]
             ) -> List[Tuple[str, float]]:
    """A job's laps in the order ``stages`` lists them."""
    if not metrics_json:
        return []
    got = metrics_json.get("stages_s", {})
    return [(s, float(got[s])) for s in stages if s in got]
