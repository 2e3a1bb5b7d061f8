"""The ``run.celegans_k31.30x`` cell's files: the cell finds its command
(``run_large``), its traffic and its readers by name; a whole run of the
harness on the CPU, at a small genome with the count streamed, is correct
unbroken and not correct with a contig removed or with no contigs file;
the judgement runs the partitioned reference; and the streamed count's
readers read nothing where its stages are absent."""
import time

import pytest

from benchlib.manifest import Cell, load_manifest
from benchlib.runner import run_cell
from benchlib.trace import JOB_SPAN
from test_bench_spans import CPU, CUDA, S, _ctx, _trace
from test_bench_trace import Ev

CELL = "run.celegans_k31.30x"
NEW = ("count_pass_s", "count_merge_s", "count_merge_busy_pct")


def test_the_cell_loads_its_command_traffic_and_readers():
    m = load_manifest()
    cell = Cell(m, CELL)
    assert cell.command.__name__ == "bench_command_run_large"
    assert cell.config["genome_bp"] == 100_286_401
    assert cell.traffic["name"] == "30x" and cell.chips == 1
    # every metric of the manifest: the isolates' per-layer ones and its own
    assert set(cell.readers) == {x["name"] for x in
                                 m["end_to_end"] + m["per_layer"]}
    sh = cell.command.shapes(cell.config, cell.traffic)
    assert (sh["reads"], sh["bases"], sh["windows"]) == (
        20_057_280, 3_008_592_000, 2_406_873_600)
    # the isolates read none of the new metrics
    assert not set(NEW) & set(Cell(m, "run.isolate_k31.30x").readers)


def _no_first_contig(real):
    def emit(groups, **kw):
        return real(groups, **kw)[1:]
    return emit


@pytest.mark.parametrize("fault", [None, "a_contig_removed",
                                   "no_contigs_file"])
def test_faults_make_correct_false(tmp_path, monkeypatch, fault):
    from reflexiv_tpu_torch import assembler, count, io

    monkeypatch.setattr(count, "STREAM_WINDOW_LIMIT", 1 << 18)
    if fault == "a_contig_removed":
        monkeypatch.setattr(assembler, "emit_contigs",
                            _no_first_contig(assembler.emit_contigs))
    elif fault == "no_contigs_file":
        monkeypatch.setattr(io, "write_contigs_fasta", lambda *a, **kw: None)
    cell = Cell(load_manifest(), CELL)
    cell.config = dict(cell.config, genome_bp=40_000, repeats=[[4, 1610]])
    res = run_cell(cell, seed=2**36 + 5, seconds=0.01, trace=False,
                   device="cpu", work=str(tmp_path),
                   t_start=time.perf_counter(), log=lambda msg: None)
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    checks = {n: c["value"] for n, c in res["checks"].items()}
    if fault == "no_contigs_file":
        assert checks["jobs_without_contigs"] == res["attempted"]
    elif fault == "a_contig_removed":
        assert checks["contigs_mismatched"] == 1


def test_judge_runs_the_partitioned_reference(tmp_path, monkeypatch):
    from benchlib.traffic import make_input
    from reference import assembly, assembly_large

    def unpartitioned(*a, **kw):
        raise AssertionError("the unpartitioned count ran")

    calls = []
    real = assembly_large.count
    monkeypatch.setattr(assembly_large, "count",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(assembly, "count", unpartitioned)
    cell = Cell(load_manifest(), CELL)
    cell.config = dict(cell.config, genome_bp=20_000, repeats=[[2, 1610]])
    fastq = str(tmp_path / "reads.fq.gz")
    make_input(fastq, cell.config, cell.traffic, 2**34 + 3)
    lines = []
    checks = cell.command.judge(cell.config, fastq, [], "cpu", lines.append)
    assert len(calls) == 1 and calls[0]["partitions"] == 16
    assert {n: c["value"] for n, c in checks.items()} == {
        "contigs_mismatched": 0, "jobs_without_contigs": 0}
    assert any("peak device memory" in line for line in lines)


@pytest.fixture(scope="module")
def readers():
    return Cell(load_manifest(), CELL).readers


def test_new_readers_read_nothing_without_their_stages(readers):
    one_pass = {"stages_s": {"run/counting": 0.1}, "counters": {}}
    streamed = {"stages_s": {"run/counting": 3.0, "count/pass": 2.0,
                             "count/merge": 0.5}, "counters": {}}
    for name in ("count_pass_s", "count_merge_s"):
        assert readers[name].read(_ctx(metrics=[one_pass, one_pass])) is None
        assert readers[name].read(_ctx(metrics=[streamed, one_pass])) is None
    assert readers["count_pass_s"].read(_ctx(metrics=[streamed] * 2)) == 2.0
    assert readers["count_merge_s"].read(_ctx(metrics=[streamed] * 2)) == 0.5
    no_merge = _trace([
        Ev(JOB_SPAN, CPU, 0, 10 * S),
        Ev("count/pass", CPU, 1 * S, 4 * S, annotation=True),
        Ev("kernel_a", CUDA, 2 * S, 3 * S),
    ])
    busy = readers["count_merge_busy_pct"]
    assert busy.read(_ctx(no_merge)) is None
    assert busy.read(_ctx(None)) is None
    merge = _trace([
        Ev(JOB_SPAN, CPU, 0, 10 * S),
        Ev("count/merge", CPU, 4 * S, 8 * S, annotation=True),
        Ev("kernel_a", CUDA, 5 * S, 6 * S),
    ])
    assert busy.read(_ctx(merge)) == pytest.approx(25.0)


def test_every_cell_reads_the_metrics_that_apply_to_it():
    """Each cell's readers are the end-to-end and per-layer metrics without
    a ``workloads`` list or whose list names the cell; every list names
    cells of the manifest, and every cell has a per-layer metric."""
    m = load_manifest()
    names = {w["name"] for w in m["workloads"]}
    metrics = m["end_to_end"] + m["per_layer"]
    for x in metrics:
        assert set(x.get("workloads", names)) <= names, x["name"]
    for w in m["workloads"]:
        want = {x["name"] for x in metrics
                if w["name"] in x.get("workloads", names)}
        cell = Cell(m, w["name"])
        assert set(cell.readers) == want
        assert {x["name"] for x in cell.per_layer}, w["name"]
