"""The ``run`` command: one single-k assembly job, as ``bin/reflexiv-tpu run``
starts it, and how its output is judged.

A job is ``reflexiv_tpu_torch.cli.main(["run", "-fastq", <file>,
"-outfile", <dir>, ...])`` with every parameter of the configuration
given on the command line. It is judged by its own ``part-00000``, as a
set of reverse-complement-canonical contigs, against the plain reference
(``reference/assembly.py``) run once on the same gzipped FASTQ.
"""
from __future__ import annotations

import os

ENTRY = ("reflexiv_tpu_torch.cli", "main")
OUTPUT = "part-00000"
# the job's laps in metrics.json, in the order they run
STAGES = ("run/ingest", "run/counting", "run/graph", "run/extension",
          "run/emit", "run/output")
PARAMS = ("kmer", "cover", "maxcov", "error", "mincontig", "maxiter",
          "miniter", "seed")


def argv(config: dict, fastq: str, outdir: str, device: str) -> list:
    out = ["run", "-fastq", fastq, "-outfile", outdir]
    for p in PARAMS:
        out += [f"-{p}", str(config[p])]
    return out + ["-device", device]


def shapes(config: dict, traffic: dict) -> dict:
    """A job's work, from the input's shapes alone."""
    from benchlib.traffic import n_reads

    R = n_reads(config["genome_bp"], config["read_len"], traffic["depth"])
    L, k = config["read_len"], config["kmer"]
    return {"reads": R, "read_len": L, "bases": R * L, "k": k,
            "windows": R * (L - k + 1), "key_words": -(-2 * k // 64)}


def assemble_reference(config: dict, fastq: str, device, fingerprint_bits=None
              ) -> dict:
    """The plain reference's assembly of ``fastq``: its canonical contig
    set, and counts along the way."""
    from reference.assembly import assemble
    from reference.fastq import canonical, read_fastq_codes

    out = assemble(read_fastq_codes(fastq), k=config["kmer"],
                   cover=config["cover"], maxcov=config["maxcov"],
                   error=config["error"], mincontig=config["mincontig"],
                   maxiter=config["maxiter"], miniter=config["miniter"],
                   seed=config["seed"], device=device,
                   fingerprint_bits=fingerprint_bits)
    out["canonical"] = {canonical(s) for s in out.pop("contigs")}
    return out


def job_contigs(outdir: str):
    """A job's canonical contig set, None where it wrote no output."""
    from reference.fastq import canonical, read_fasta

    path = os.path.join(outdir, OUTPUT)
    if not os.path.isfile(path):
        return None
    return {canonical(s) for _h, s in read_fasta(path)}


def judge(config: dict, fastq: str, outdirs, device, log) -> dict:
    """Checks of the window's jobs, each ``{"value", "limit"}``: contigs
    that one side has and the other lacks, in the worst job (an exact
    comparison, limit 0), and the jobs that left no contigs file."""
    ref = assemble_reference(config, fastq, device)
    want = ref["canonical"]
    log(f"reference: {ref['solid_kmers']} solid k-mers, {ref['records']} "
        f"records, {ref['rounds']} rounds, {len(want)} canonical contigs, "
        f"{sum(map(len, want))} bp")
    worst, missing = 0, 0
    for d in outdirs:
        got = job_contigs(d)
        if got is None:
            missing += 1
            continue
        worst = max(worst, len(got ^ want))
    return {"contigs_mismatched": {"value": worst, "limit": 0},
            "jobs_without_contigs": {"value": missing, "limit": 0}}
