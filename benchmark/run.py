"""Benchmark of the PyTorch + CUDA port, ``reflexiv_tpu_torch``: one run of
one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload run.isolate_k31.30x --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number judged, with its limit.
The same checks are the last lines of standard error. Exits 1 and prints
no result without the cards, without the program beside the benchmark,
or if JAX or the JAX package was loaded.

Inputs and job outputs go to a directory under ``TMPDIR``, removed at
exit; the program's kernel library is built once into the checkout's
``build/`` and reused by every later run there.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "reflexiv_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def set_environment() -> None:
    """The program's default path: no ``REFLEXIV_*`` setting. Caches that a
    library would keep go to fixed directories inside the checkout."""
    for name in [n for n in os.environ if n.startswith("REFLEXIV_")]:
        del os.environ[name]
    build = os.path.join(CHECKOUT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    sys.path.insert(0, BENCH_DIR)
    sys.path.insert(1, CHECKOUT)
    from benchlib.manifest import Cell, load_manifest

    cell = Cell(load_manifest(CHECKOUT), args.workload)
    try:
        __import__(cell.command.ENTRY[0])
    except ImportError as e:
        say(f"benchmark: the program is not beside the benchmark ({e})")
        return 1
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} present")
        return 1
    work = tempfile.mkdtemp(prefix="reflexiv-bench-")
    try:
        from benchlib.runner import run_cell

        result = run_cell(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda:0", work=work,
                          t_start=T_START, log=say)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = forbidden_modules()
    if found:
        say(f"benchmark: forbidden modules loaded: {', '.join(found)}")
        return 1
    say(f"correct: {result['correct']}")
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
