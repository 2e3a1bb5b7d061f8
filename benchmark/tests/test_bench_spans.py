"""The readers of the program's own ranges on a made-up event list: the
card's busy share of the ``run/extension`` ranges, which counts no device
work outside them, sums over jobs and reads nothing without a range; and
ingest's two passes, read from ``metrics.json`` where the program writes
them."""
import pytest
import torch

from benchlib.manifest import Cell, load_manifest
from benchlib.runner import Context, Job
from benchlib.trace import JOB_SPAN, Trace
from test_bench_trace import Ev, Prof

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
S = 1_000_000_000
EXT = "run/extension"


@pytest.fixture(scope="module")
def readers():
    return Cell(load_manifest(), "run.isolate_k31.30x").readers


def _ctx(trace=None, metrics=()):
    jobs = []
    for m in metrics:
        j = Job("out", 1.0, True, 0)
        j.metrics = m
        jobs.append(j)
    return Context(setup_s=1.0, window_s=10.0, jobs=jobs, shapes={},
                   trace=trace)


def _trace(events):
    return Trace(Prof(events), [])


def test_busy_half_inside_the_range(readers):
    tr = _trace([
        Ev(JOB_SPAN, CPU, 0, 10 * S),
        Ev("run", CPU, 0, 10 * S, annotation=True),
        Ev(EXT, CPU, 2 * S, 6 * S, annotation=True),
        Ev("kernel_a", CUDA, 4 * S, 8 * S),
    ])
    assert readers["extension_busy_pct"].read(_ctx(tr)) == pytest.approx(50.0)


def test_a_kernel_outside_every_range_is_not_counted(readers):
    tr = _trace([
        Ev(JOB_SPAN, CPU, 0, 10 * S),
        Ev(EXT, CPU, 2 * S, 6 * S, annotation=True),
        Ev("kernel_a", CUDA, S // 2, S),          # before the range
        Ev("kernel_b", CUDA, 3 * S, 4 * S),
        Ev("kernel_c", CUDA, 7 * S, 9 * S),       # after it
    ])
    assert tr.busy_s == pytest.approx(3.5)
    assert readers["extension_busy_pct"].read(_ctx(tr)) == pytest.approx(25.0)


def test_two_ranges_in_two_jobs(readers):
    tr = _trace([
        Ev(JOB_SPAN, CPU, 0, 5 * S),
        Ev(JOB_SPAN, CPU, 5 * S, 10 * S),
        Ev(EXT, CPU, 1 * S, 3 * S, annotation=True),
        Ev(EXT, CPU, 6 * S, 8 * S, annotation=True),
        Ev("kernel_a", CUDA, 2 * S, 3 * S),
        Ev("kernel_b", CUDA, 2 * S + S // 2, 4 * S),   # overlaps kernel_a
        Ev("kernel_a", CUDA, 6 * S, 6 * S + S // 2),
        Ev(EXT, CPU, 6 * S, 8 * S, tid=2),        # another thread: not read
    ])
    # (1 + 0.5) s busy of 4 s of ranges
    assert readers["extension_busy_pct"].read(_ctx(tr)) == pytest.approx(37.5)


def test_no_range_reads_nothing(readers):
    tr = _trace([
        Ev(JOB_SPAN, CPU, 0, 10 * S),
        Ev("run/ingest", CPU, 0, 4 * S, annotation=True),
        Ev("kernel_a", CUDA, 4 * S, 8 * S),
    ])
    assert readers["extension_busy_pct"].read(_ctx(tr)) is None
    assert readers["extension_busy_pct"].read(_ctx(None)) is None


def test_ingest_passes_read_none_without_their_keys(readers):
    old = {"stages_s": {"run/ingest": 4.0}, "counters": {}}
    new = {"stages_s": {"run/ingest": 4.0, "ingest/scan": 1.5,
                        "ingest/load": 2.4}, "counters": {}}
    for name in ("ingest_scan_s", "ingest_load_s"):
        assert readers[name].read(_ctx(metrics=[old, old])) is None
        assert readers[name].read(_ctx(metrics=[new, old])) is None
    assert readers["ingest_scan_s"].read(_ctx(metrics=[new, new])) == 1.5
    assert readers["ingest_load_s"].read(_ctx(metrics=[new, new])) == 2.4
