"""The ``run`` command on a genome whose windows the plain reference cannot
count in one piece: the same job, shapes and exact judgement as
``commands/run.py``, against ``reference/assembly_large.py`` (the count
partitioned by key range).

A job is ``commands/run.py``'s: ``reflexiv_tpu_torch.cli.main(["run",
"-fastq", <file>, "-outfile", <dir>, ...])`` with every parameter of the
configuration on the command line, judged by its own ``part-00000`` as a
set of reverse-complement-canonical contigs.
"""
from __future__ import annotations

import os
import time

from benchlib.manifest import load_module

_RUN = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "run.py"), "bench_command_run")
ENTRY, OUTPUT, STAGES = _RUN.ENTRY, _RUN.OUTPUT, _RUN.STAGES
argv, shapes, job_contigs = _RUN.argv, _RUN.shapes, _RUN.job_contigs


def assemble_reference(config: dict, fastq: str, device,
                       fingerprint_bits=None) -> dict:
    """The partitioned reference's assembly of ``fastq``: its canonical
    contig set, and counts along the way; ``fingerprint_bits``, the
    control, as in ``commands/run.py``."""
    from reference.assembly_large import assemble
    from reference.fastq import canonical, read_fastq_codes

    out = assemble(read_fastq_codes(fastq), k=config["kmer"],
                   cover=config["cover"], maxcov=config["maxcov"],
                   error=config["error"], mincontig=config["mincontig"],
                   maxiter=config["maxiter"], miniter=config["miniter"],
                   seed=config["seed"], device=device,
                   fingerprint_bits=fingerprint_bits)
    out["canonical"] = {canonical(s) for s in out.pop("contigs")}
    return out


# run.py's judge, its comparison and checks, against this reference
_RUN.assemble_reference = assemble_reference


def judge(config: dict, fastq: str, outdirs, device, log) -> dict:
    """``commands/run.py``'s checks, each ``{"value", "limit"}``, against
    the partitioned reference run once on the same file: contigs that one
    side has and the other lacks, in the worst job (limit 0), and the jobs
    that left no contigs file. Logs the reference's seconds and its peak
    device memory."""
    import torch

    cuda = str(device).startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    checks = _RUN.judge(config, fastq, outdirs, device, log)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"reference and comparison: {time.perf_counter() - t:.2f} s, peak "
        f"device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    return checks
