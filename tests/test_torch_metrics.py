"""The port's stage timers: ``Metrics.stage`` accumulates its timer, and
while a ``torch.profiler`` profile records it is also a range of the same
name on the profiler's clock (and opens none otherwise); the ``run``
command's stages, ingest's pass over the input and its matrix and their
ranges, nested in order, and the one-pass ingest's counters, gzip members
read on every thread among them."""
import torch_threads  # noqa: F401
import gzip
import json
import os
import random
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from reflexiv_tpu_torch import cli, ingest, metrics, native

RUN_STAGES = ("run/ingest", "run/counting", "run/graph", "run/extension",
              "run/emit", "run/output")


def _ranges(prof, names):
    """``(start, end, name)`` of the profiler's user-annotation events
    named in ``names``, in start order."""
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name() in names]
    return sorted(out)


def test_stage_accumulates_with_and_without_profiler():
    m = metrics.Metrics()
    with m.stage("a"):
        time.sleep(0.01)
    first = m.timers["a"]
    assert first >= 0.01
    with profile(activities=[ProfilerActivity.CPU]):
        with m.stage("a"):
            time.sleep(0.01)
    assert m.timers["a"] >= first + 0.01
    with m.stage("b", quiet=True):
        pass
    assert set(m.timers) == {"a", "b"}


def test_stage_is_a_user_annotation_under_the_profiler():
    m = metrics.Metrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.stage("outer"):
            with m.stage("inner"):
                time.sleep(0.002)
            with m.stage("inner"):
                time.sleep(0.002)
    got = _ranges(prof, {"outer", "inner"})
    assert [n for _s, _e, n in got] == ["outer", "inner", "inner"]
    (o0, o1, _), (a0, a1, _), (b0, b1, _) = got
    assert o0 <= a0 < a1 <= b0 < b1 <= o1


def test_stage_opens_no_range_without_a_profiler(monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(metrics, "record_function", Range)
    m = metrics.Metrics()
    with m.stage("off"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with m.stage("on"):
            pass
    assert opened == ["on"]
    assert set(m.timers) == {"off", "on"}


@pytest.fixture(scope="module")
def gz_fastq(tmp_path_factory):
    """A gzipped FASTQ of error-free 100 bp reads at 20x over a 3 kb
    random genome, both strands."""
    rng = random.Random(16)
    genome = "".join(rng.choice("ACGT") for _ in range(3000))
    comp = str.maketrans("ACGT", "TGCA")
    path = str(tmp_path_factory.mktemp("metrics") / "reads.fq.gz")
    with gzip.open(path, "wt") as fh:
        for i in range(600):
            s = rng.randrange(len(genome) - 100 + 1)
            r = genome[s:s + 100]
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
            fh.write(f"@r{i}\n{r}\n+\n{'I' * 100}\n")
    return path


def _run(fastq, out):
    assert cli.main(["run", "-fastq", fastq, "-kmer", "21", "-cover", "2",
                     "-mincontig", "300", "-outfile", out,
                     "-device", "cpu"]) == 0
    with open(os.path.join(out, "metrics.json")) as fh:
        return json.load(fh)


def test_cli_run_writes_the_run_stages(gz_fastq, tmp_path):
    met = _run(gz_fastq, str(tmp_path / "asm"))
    for name in RUN_STAGES + ("run",):
        assert name in met["stages_s"], name
    assert met["counters"]["run/extension_rounds"] > 0
    assert met["counters"]["run/contigs"] > 0


def test_cli_run_splits_ingest(gz_fastq, tmp_path):
    if native._get_lib() is None:
        pytest.skip("the native library is not available")
    got = _run(gz_fastq, str(tmp_path / "asm"))["stages_s"]
    scan, load = got["ingest/scan"], got["ingest/load"]
    assert scan > 0 and load > 0
    # metrics.json rounds each timer to the millisecond
    assert scan + load <= got["run/ingest"] + 0.002


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_cli_run_counts_the_one_pass(gz_fastq, tmp_path, fmt):
    """``run`` reads the gzipped FASTQ in one pass, inflating its text
    once; the same reads as one-line plain FASTA too, since FASTQ mode
    reads every file first (and keeps every other record of it, ROADMAP
    Queue 3)."""
    if ingest.lib() is None or native._get_lib() is None:
        pytest.skip("the one-pass or the native library is not available")
    with gzip.open(gz_fastq, "rb") as fh:
        text = fh.read()
    path, want = gz_fastq, (1, len(text))
    if fmt == "fasta":
        lines = text.decode().splitlines()
        path = str(tmp_path / "reads.fa")
        with open(path, "w") as fh:
            fh.writelines(f">{h[1:]}\n{s}\n"
                          for h, s in zip(lines[0::4], lines[1::4]))
        want = (1, os.path.getsize(path))
    met = _run(path, str(tmp_path / "asm"))
    counts = met["counters"]
    assert (counts["ingest/one_pass_files"],
            counts["ingest/inflated_bytes"]) == want
    assert met["stages_s"]["ingest/inflate_wait_s"] >= 0


def test_cli_run_ranges_nest_in_order(gz_fastq, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(gz_fastq, str(tmp_path / "asm"))
    got = _ranges(prof, set(RUN_STAGES) | {"run", "ingest/scan",
                                           "ingest/load"})
    (r0, r1, name), stages = got[0], [g for g in got if g[2] in RUN_STAGES]
    assert name == "run"
    assert [n for _s, _e, n in stages] == list(RUN_STAGES)
    at = r0
    for s, e, n in stages:
        assert at <= s < e <= r1, n
        at = e
    if native._get_lib() is not None:
        i0, i1, _ = stages[0]
        inner = [g for g in got if g[2].startswith("ingest/")]
        assert [n for _s, _e, n in inner] == ["ingest/scan", "ingest/load"]
        assert i0 <= inner[0][0] and inner[0][1] <= inner[1][0]
        assert inner[1][1] <= i1


def test_cli_run_reads_gzip_members_on_every_thread(gz_fastq, tmp_path):
    """``run`` on the reads as three gzip members: the chain accepts all
    three, no file falls back to one thread, and the contigs equal those
    of the same reads as one member."""
    if ingest.lib() is None or native._get_lib() is None:
        pytest.skip("the one-pass or the native library is not available")
    with gzip.open(gz_fastq, "rb") as fh:
        text = fh.read()
    cuts = [0, len(text) // 3, 2 * len(text) // 3, len(text)]
    path = str(tmp_path / "members.fq.gz")
    with open(path, "wb") as fh:
        for a, b in zip(cuts[:-1], cuts[1:]):
            fh.write(gzip.compress(text[a:b]))
    counts = _run(path, str(tmp_path / "members"))["counters"]
    assert counts["ingest/members"] == 3
    assert counts["ingest/member_fallbacks"] == 0
    assert counts["ingest/inflated_bytes"] == len(text)
    one = _run(gz_fastq, str(tmp_path / "one"))["counters"]
    assert one["ingest/members"] == 0
    with open(tmp_path / "members" / "part-00000", "rb") as fh:
        got = fh.read()
    with open(tmp_path / "one" / "part-00000", "rb") as fh:
        want = fh.read()
    assert got and got == want
