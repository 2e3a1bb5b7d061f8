"""The manifest and the files it names: every name resolves to its file,
and a cell, configuration, traffic mix, command or metric added as new
files and entries is found with no edit to the harness."""
import json
import os
import re
import shutil

import pytest

from benchlib.manifest import BENCH_DIR, CHECKOUT, Cell, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_names_and_files():
    m = load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = m["end_to_end"] + m["per_layer"]
    for entry in m["configs"] + m["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for metric in metrics:
        assert UNIT.match(metric["unit"]) and metric["better"] in (
            "lower", "higher")
    e2e = {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e
    for w in m["workloads"]:
        cell = Cell(m, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.readers) == {x["name"] for x in metrics}
        assert len(w["why"]) <= 200


def _copy_benchmark(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), root)
    return root


def test_new_files_are_found_without_a_harness_edit(tmp_path):
    root = _copy_benchmark(tmp_path)
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "isolate_k31.json").read_text())
    config.update(name="isolate_k41", kmer=41, command="newcmd")
    (bench / "configs" / "isolate_k41.json").write_text(json.dumps(config))
    (bench / "traffic" / "50x.json").write_text(json.dumps(
        {"name": "50x", "depth": 50, "error_rate": 0.01}))
    (bench / "commands" / "newcmd.py").write_text(
        "ENTRY = ('reflexiv_tpu_torch.cli', 'main')\nSTAGES = ()\n")
    (bench / "metrics" / "jobs_done.py").write_text(
        "def read(ctx):\n    return len(ctx.jobs)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "isolate_k41", "source": "x",
                         "file": "benchmark/configs/isolate_k41.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "newcmd.isolate_k41.50x",
                           "config": "isolate_k41", "traffic": "50x",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "harness", "moves": "read_mbp_per_s",
                           "workloads": ["newcmd.isolate_k41.50x"]})
    cell = Cell(m, "newcmd.isolate_k41.50x", root=str(root),
                bench_dir=str(bench))
    assert cell.config["kmer"] == 41 and cell.traffic["depth"] == 50
    assert cell.command.ENTRY[0] == "reflexiv_tpu_torch.cli"
    # the new metric is this cell's alone; the others' lists do not name it
    assert [x["name"] for x in cell.per_layer] == ["jobs_done"]

    class Ctx:
        jobs = [object()] * 3

    assert cell.read(Ctx(), traced=True) == {
        "jobs_done": {"value": 3, "unit": "jobs"}}
    old = Cell(m, "run.isolate_k31.30x", root=str(root), bench_dir=str(bench))
    assert "jobs_done" not in old.readers


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        Cell(load_manifest(), "no.such.cell")
