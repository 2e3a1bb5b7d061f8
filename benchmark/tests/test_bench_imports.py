"""What the benchmark may load: no module under the benchmark's folder
imports JAX or the JAX package (top-level names compared whole, so the
port's ``reflexiv_tpu_torch`` is not ``reflexiv_tpu``), and the reference
imports nothing of the program either."""
import ast
import os
import subprocess
import sys

import pytest

from benchlib.manifest import BENCH_DIR, CHECKOUT

JAX = {"jax", "jaxlib", "flax", "reflexiv_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(top):
    for base, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {(p, name) for p in _files(BENCH_DIR) for name in _imports(p)
             if name in JAX}
    assert not found


def test_top_level_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, BENCH_DIR)
    import run

    for name in ("reflexiv_tpu_torch.cli", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "reflexiv_tpu.cli", object())
    assert run.forbidden_modules() == ["reflexiv_tpu.cli"]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    names = {n for p in _files(ref) for n in _imports(p)}
    assert not names & (JAX | {"reflexiv_tpu_torch", "benchlib", "chip_smoke"})
    code = ("import sys; sys.path[:0] = [%r]; import reference.assembly, "
            "reference.fastq; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))" % BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/").stdout
    assert "reflexiv_tpu_torch" not in out and "'jax'" not in out


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits with an error and prints no result."""
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "run.isolate_k31.30x", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "not beside the benchmark" in proc.stderr


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "run.isolate_k31.30x", "--seed", "1", "--seconds", "1"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
