"""The benchmark's own tests. They run on the CPU at small sizes; the ones
marked ``cuda`` need a card and skip without one.

    python -m pytest -q benchmark/tests
"""
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH_DIR)
for p in (CHECKOUT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)
