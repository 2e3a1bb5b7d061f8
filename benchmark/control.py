"""The comparison's two readings at a cell's own size, on several seeds in
one process: the program's (one warm job of the cell against the plain
reference) and the control's (the reference counting k-mers by a
fingerprint of ``--bits`` bits, put in the program's place).

    python3 benchmark/control.py --workload run.isolate_k31.30x \
        --seeds 11,12,13 [--bits 32]

Needs a CUDA card. One JSON line a seed: ``program`` and ``control``, each
the number of canonical contigs one side has and the exact reference
lacks, or the other way round (the runs' ``contigs_mismatched``). The
benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--bits", type=int, default=32)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, CHECKOUT]
    import run
    from benchlib.manifest import Cell, load_manifest
    from benchlib.runner import entry_of, run_job
    from benchlib.traffic import make_input

    run.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 1
    cell = Cell(load_manifest(CHECKOUT), args.workload)
    cmd, entry = cell.command, entry_of(cell.command)
    work = tempfile.mkdtemp(prefix="reflexiv-control-")
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            fastq = os.path.join(work, "reads.fq.gz")
            make_input(fastq, cell.config, cell.traffic, seed)
            out = os.path.join(work, f"job{seed}")
            job = run_job(entry, cmd.argv(cell.config, fastq, out, "cuda:0"),
                          out, "cuda:0", lambda m: print(m, file=sys.stderr))
            got = cmd.job_contigs(out) if job.ok else None
            torch.cuda.empty_cache()
            t = time.perf_counter()
            exact = cmd.assemble_reference(cell.config, fastq, "cuda:0")
            t_ref = time.perf_counter() - t
            ctl = cmd.assemble_reference(cell.config, fastq, "cuda:0",
                                         fingerprint_bits=args.bits)
            want = exact["canonical"]
            print(json.dumps({
                "workload": args.workload, "seed": seed, "bits": args.bits,
                "program": None if got is None else len(got ^ want),
                "control": len(ctl["canonical"] ^ want),
                "job_s": job.seconds, "reference_s": t_ref,
                "contigs": len(want), "contig_bp": sum(map(len, want)),
                "solid_kmers": exact["solid_kmers"],
                "control_solid_kmers": ctl["solid_kmers"],
                "rounds": exact["rounds"], "control_rounds": ctl["rounds"]}),
                flush=True)
            shutil.rmtree(out, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
