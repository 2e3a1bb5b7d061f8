"""One run of one cell: set-up, the measured window of jobs, the judgement
and the metrics.

The loop is closed: a job starts when the one before it has written its
output. Jobs start until the first one that ends at or after ``seconds``;
the window runs from the first job's start to the last job's end, so it
holds no partial job. Set-up (imports, CUDA, the program's kernel
library, the input made and written, one warm-up job of the same shape)
is timed from the process's start to the first timed job.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import time
import traceback
from typing import Callable, List, Optional

from benchlib import peaks
from benchlib.traffic import make_input


class Job:
    def __init__(self, outdir: str, seconds: float, ok: bool,
                 peak_bytes: int):
        self.outdir = outdir
        self.seconds = seconds
        self.ok = ok
        self.peak_bytes = peak_bytes
        self.metrics: Optional[dict] = None

    def load_metrics(self) -> None:
        path = os.path.join(self.outdir, "metrics.json")
        if os.path.isfile(path):
            with open(path) as fh:
                self.metrics = json.load(fh)


class Context:
    """What a metric reader reads: the window's jobs and their
    ``metrics.json``, the host clock's set-up and window, the input's
    shapes, the trace (None in an untraced run) and the chip's peaks."""

    def __init__(self, *, setup_s, window_s, jobs, shapes, trace):
        self.setup_s = setup_s
        self.window_s = window_s
        self.all_jobs = jobs
        self.jobs = [j for j in jobs if j.ok]
        self.shapes = shapes
        self.trace = trace
        self.peaks = peaks

    def mean_lap(self, *names) -> Optional[float]:
        """Mean per job of the sum of these ``metrics.json`` laps."""
        vals = []
        for j in self.jobs:
            got = (j.metrics or {}).get("stages_s", {})
            if not all(n in got for n in names):
                return None
            vals.append(sum(got[n] for n in names))
        return sum(vals) / len(vals) if vals else None

    def mean_counter(self, name) -> Optional[float]:
        vals = [(j.metrics or {}).get("counters", {}).get(name)
                for j in self.jobs]
        if not vals or any(v is None for v in vals):
            return None
        return sum(vals) / len(vals)


def entry_of(command) -> Callable:
    module, fn = command.ENTRY
    return getattr(importlib.import_module(module), fn)


def run_job(entry, argv: List[str], outdir: str, device: str, log) -> Job:
    """One job, timed to its end on the device; a failure is logged and
    counted, not raised."""
    import torch

    cuda = device.startswith("cuda")
    t0 = time.perf_counter()
    ok = False
    try:
        ok = entry(argv) == 0
        if cuda:
            torch.cuda.synchronize()
    except (Exception, SystemExit):   # a job that fails is counted, not fatal
        log("job failed:\n" + traceback.format_exc())
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    return Job(outdir, seconds, ok, peak)


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device: str,
             work: str, t_start: float, log) -> dict:
    """Set-up, window, judgement and metrics of one run of ``cell``
    (``log`` takes the progress lines). Returns the result line's keys,
    the checks last."""
    import torch

    cmd = cell.command
    entry = entry_of(cmd)
    fastq = os.path.join(work, "reads.fq.gz")
    t = time.perf_counter()
    made = make_input(fastq, cell.config, cell.traffic, seed)
    log(f"input: {made['reads']} reads x {made['read_len']} bp, "
        f"{made['gz_bytes']} gzip bytes, made in "
        f"{time.perf_counter() - t:.2f} s")
    shapes = cmd.shapes(cell.config, cell.traffic)

    def argv(outdir):
        return cmd.argv(cell.config, fastq, outdir, device)

    warm = os.path.join(work, "warmup")
    job = run_job(entry, argv(warm), warm, device, log)
    if not job.ok:
        raise RuntimeError("the warm-up job failed")
    log(f"warm-up job: {job.seconds:.3f} s")
    setup_s = time.perf_counter() - t_start

    prof, span = None, contextlib.nullcontext
    jobs: List[Job] = []
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)

            from benchlib.trace import JOB_SPAN
            acts = [ProfilerActivity.CPU]
            if device.startswith("cuda"):
                acts.append(ProfilerActivity.CUDA)
            prof = stack.enter_context(profile(activities=acts))
            span = lambda: record_function(JOB_SPAN)  # noqa: E731
        t_window = time.perf_counter()
        while True:
            outdir = os.path.join(work, f"job{len(jobs):04d}")
            with span():
                jobs.append(run_job(entry, argv(outdir), outdir, device,
                                    log))
            window_s = time.perf_counter() - t_window
            if window_s >= seconds:
                break
    memory_peak = max(j.peak_bytes for j in jobs)
    for i, j in enumerate(jobs):
        j.load_metrics()
        laps = (j.metrics or {}).get("stages_s", {})
        log(f"job {i}: {j.seconds:.3f} s, " + ", ".join(
            f"{s} {laps[s]:.3f}" for s in cmd.STAGES if s in laps))
    log(f"window: {len(jobs)} jobs in {window_s:.3f} s")

    tr = None
    if prof is not None:
        from benchlib.trace import Trace, job_laps
        t = time.perf_counter()
        tr = Trace(prof, [job_laps(j.metrics, cmd.STAGES) for j in jobs])
        del prof
        log(f"trace read in {time.perf_counter() - t:.2f} s: busy "
            f"{tr.busy_s:.3f} s of {tr.window_s:.3f} s")

    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = cmd.judge(cell.config, fastq, [j.outdir for j in jobs], device,
                       log)
    log(f"judged in {time.perf_counter() - t:.2f} s")

    ctx = Context(setup_s=setup_s, window_s=window_s, jobs=jobs,
                  shapes=shapes, trace=tr)
    failed = sum(not j.ok for j in jobs)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0)
           if device.startswith("cuda") else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": cell.read(ctx, traced=trace), "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result
