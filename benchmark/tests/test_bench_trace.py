"""The trace reduction on a made-up event list: busy time is the union of
device activity inside the window, span shadows on the device are not
device work, and idle gaps are put down to the stage and host operation
across them."""
import pytest
import torch

from benchlib.trace import JOB_SPAN, Trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, tid=1, annotation=False):
        self._v = (name, dev, start, end, tid, annotation)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3] - self._v[2]
    def start_thread_id(self): return self._v[4]
    def is_user_annotation(self): return self._v[5]


class Prof:
    def __init__(self, events):
        class R:
            def events(self_inner):
                return events

        class P:
            kineto_results = R()

        self.profiler = P()


S = 1_000_000_000


def test_busy_idle_and_labels():
    events = [
        Ev(JOB_SPAN, CPU, 0, 10 * S),
        Ev(JOB_SPAN, CUDA, 4 * S, 9 * S, annotation=True),
        Ev("aten::sort", CPU, 4 * S, 6 * S),
        Ev("aten::item", CPU, 7 * S, 9 * S),
        Ev("kernel_a", CUDA, 4 * S, 5 * S),
        Ev("kernel_b", CUDA, 4 * S + S // 2, 6 * S),   # overlaps kernel_a
        Ev("Memcpy DtoH", CUDA, 9 * S, 10 * S),
        Ev("kernel_a", CUDA, 11 * S, 12 * S),          # after the window
    ]
    laps = [[("run/ingest", 4.0), ("run/counting", 2.0),
             ("run/extension", 4.0)]]
    tr = Trace(Prof(events), laps)
    assert tr.window_s == 10.0
    assert tr.busy_s == pytest.approx(3.0)
    assert tr.kernel_seconds(r"^kernel_a$") == pytest.approx(2.0)
    bd = tr.breakdown()
    assert [n for n, _t in bd["device_ops"]] == [
        "kernel_a", "kernel_b", "Memcpy DtoH"]
    assert dict(map(tuple, bd["idle_gaps"])) == pytest.approx({
        "run/ingest | no traced op": 4.0,
        "run/extension | aten::item": 3.0})
