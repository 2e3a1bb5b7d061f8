"""The roofline readers: work counted from the input's shapes alone, and
nothing read where the trace has no such kernel."""
import pytest

from benchlib import peaks
from benchlib.manifest import Cell, load_manifest


class FakeTrace:
    def __init__(self, names):
        self.names = names

    def kernel_seconds(self, pattern):
        import re
        return sum(t for n, t in self.names.items() if re.search(pattern, n))


class Ctx:
    def __init__(self, shapes, trace, jobs=2):
        self.shapes, self.trace, self.peaks = shapes, trace, peaks
        self.jobs = [object()] * jobs


def _cell(name):
    return Cell(load_manifest(), name)


@pytest.mark.parametrize("name, reads, L, k, words", [
    ("run.isolate_k31.30x", 1_392_495, 100, 31, 1),
    ("run.isolate_k67.30x", 928_330, 150, 67, 3),
    ("run.isolate_k31.100x", 4_641_652, 100, 31, 1),
])
def test_bytes_follow_from_shapes(name, reads, L, k, words):
    cell = _cell(name)
    shapes = cell.command.shapes(cell.config, cell.traffic)
    windows = reads * (L - k + 1)
    assert shapes == {"reads": reads, "read_len": L, "bases": reads * L,
                      "k": k, "windows": windows, "key_words": words}
    ext, srt = cell.readers["extract_roofline"], cell.readers["sort_roofline"]
    assert ext.least_bytes(shapes) == reads * (L + 4) + windows * words * 8
    assert srt.least_bytes(shapes) == 2 * windows * words * 8
    names = {
        "void (anonymous namespace)::extract_canonical_kernel<1>(x)": 1e-3,
        "void (anonymous namespace)::onesweep_kernel<false>(x)": 4e-3,
        "(anonymous namespace)::scan_kernel(unsigned int*)": 1e-3,
        "void at::native::vectorized_elementwise_kernel<4>(x)": 9.0}
    ctx = Ctx(shapes, FakeTrace(names), jobs=2)
    assert ext.read(ctx) == pytest.approx(
        100 * 2 * ext.least_bytes(shapes) / peaks.HBM_BYTES_S / 1e-3)
    assert srt.read(ctx) == pytest.approx(
        100 * 2 * srt.least_bytes(shapes) / peaks.HBM_BYTES_S / 5e-3)


def test_nothing_read_without_the_kernels():
    cell = _cell("run.isolate_k31.30x")
    shapes = cell.command.shapes(cell.config, cell.traffic)
    ctx = Ctx(shapes, FakeTrace({"void at::native::fill(x)": 1.0}))
    for name in ("extract_roofline", "sort_roofline"):
        assert cell.readers[name].read(ctx) is None
        assert cell.readers[name].read(Ctx(shapes, None)) is None
