#!/usr/bin/env python3
"""Warm ``run`` walls of this checkout and another, in turns, on one card.

    python3 scripts/run_wall_ab.py --other DIR [--seed N] [--repeats 5]
        [--rounds 2]

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive``). The FASTQ is ``chip_smoke.py``'s
4,641,652 bp input, made once from ``--seed``. Each round starts one
process per checkout, in the order other, this, this, other (so 2 rounds
give 8 processes); a process imports ``reflexiv_tpu_torch`` from its
checkout and runs ``cli run -kmer 31 -cover 3 -device cuda`` once
unrecorded, then ``--repeats`` times, printing each wall (host clock; the
command ends with its results on disk). The last line gives each
checkout's median and its walls. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(tree: str, fastq: str, repeats: int) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    from reflexiv_tpu_torch import cli

    out = tempfile.mkdtemp(prefix="run_wall_", dir=os.path.dirname(fastq))
    walls = []
    for r in range(repeats + 1):
        t0 = time.perf_counter()
        rc = cli.main(["run", "-fastq", fastq, "-kmer", "31", "-cover", "3",
                       "-outfile", os.path.join(out, str(r)),
                       "-device", "cuda"])
        if rc != 0:
            raise SystemExit(f"run exited {rc} in {tree}")
        if r:
            walls.append(time.perf_counter() - t0)
    shutil.rmtree(out)
    print(json.dumps(walls))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--fastq", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.fastq, args.repeats)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="run_wall_ab_",
                            dir=os.path.join(REPO, "build"))
    walls = {"other": [], "this": []}
    try:
        fastq = os.path.join(work, "reads.fq")
        _genome, reads = chip_smoke.simulate(np.random.default_rng(args.seed),
                                             chip_smoke.GENOME_BP)
        chip_smoke.write_fastq(fastq, reads)
        del reads
        trees = {"other": args.other, "this": REPO}
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                got = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--other",
                     args.other, "--worker", trees[name], "--fastq", fastq,
                     "--repeats", str(args.repeats)],
                    capture_output=True, text=True, check=True)
                w = json.loads(got.stdout.strip().splitlines()[-1])
                walls[name] += w
                print(f"{name} ({trees[name]}): walls s "
                      f"{', '.join(f'{x:.3f}' for x in w)}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({name: {"median_s": float(np.median(w)), "walls_s": w}
                      for name, w in walls.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
