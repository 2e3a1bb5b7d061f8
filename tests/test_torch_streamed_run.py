"""``run`` with its count streamed in several passes, against the
benchmark's partitioned plain reference (``benchmark/reference/
assembly_large.py``), on a small genome in the ``celegans_k31``
configuration's reads (150 bp, 30x, both strands, 0.5% redraws, gzip):
the contigs agree, the job writes the streamed count's stages and
counter, and each stage is a range under the profiler; the partitioned
count equals the unpartitioned reference's row for row."""
import torch_threads  # noqa: F401
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from benchlib.traffic import make_genome, make_input, sample_reads  # noqa: E402
from reference import assembly, assembly_large  # noqa: E402
from reference.fastq import canonical, read_fasta, read_fastq_codes  # noqa: E402

from reflexiv_tpu_torch import cli, count  # noqa: E402

SMALL_BP = 40_000
# 8,000 reads of 120 windows: 2^18 windows a pass gives 2,184 rows a pass,
# so four passes and three merges
PASS_WINDOWS = 1 << 18
STREAM_STAGES = {"count/pass", "count/merge"}


def _config():
    with open(os.path.join(BENCH_DIR, "configs", "celegans_k31.json")) as fh:
        config = json.load(fh)
    with open(os.path.join(BENCH_DIR, "traffic", "30x.json")) as fh:
        traffic = json.load(fh)
    return dict(config, genome_bp=SMALL_BP, repeats=[[4, 1610]]), traffic


def _argv(config, fastq, outdir):
    out = ["run", "-fastq", fastq, "-outfile", outdir]
    for p in ("kmer", "cover", "maxcov", "error", "mincontig", "maxiter",
              "miniter", "seed"):
        out += [f"-{p}", str(config[p])]
    return out + ["-device", "cpu"]


def _annotations(prof, names):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name() in names]


@pytest.fixture(scope="module")
def streamed_job(tmp_path_factory):
    """One streamed ``run`` job on the small genome, traced on the CPU:
    its canonical contigs, ``metrics.json``, the profiler's annotations,
    the config and the input file."""
    config, traffic = _config()
    root = tmp_path_factory.mktemp("streamed")
    fastq = str(root / "reads.fq.gz")
    make_input(fastq, config, traffic, 2**33 + 19)
    outdir = str(root / "out")
    mp = pytest.MonkeyPatch()
    mp.setattr(count, "STREAM_WINDOW_LIMIT", PASS_WINDOWS)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert cli.main(_argv(config, fastq, outdir)) == 0
    finally:
        mp.undo()
    with open(os.path.join(outdir, "metrics.json")) as fh:
        met = json.load(fh)
    contigs = {canonical(s) for _h, s in
               read_fasta(os.path.join(outdir, "part-00000"))}
    return {"contigs": contigs, "metrics": met, "config": config,
            "fastq": fastq, "ranges": _annotations(prof, STREAM_STAGES)}


def test_streamed_run_equals_the_partitioned_reference(streamed_job):
    config = streamed_job["config"]
    ref = assembly_large.assemble(
        read_fastq_codes(streamed_job["fastq"]), k=config["kmer"],
        cover=config["cover"], maxcov=config["maxcov"],
        error=config["error"], mincontig=config["mincontig"],
        maxiter=config["maxiter"], miniter=config["miniter"],
        seed=config["seed"], device="cpu", partitions=3,
        block_windows=100_000)
    want = {canonical(s) for s in ref["contigs"]}
    assert streamed_job["contigs"] == want
    assert sum(map(len, want)) > 0.9 * SMALL_BP
    assert streamed_job["metrics"]["counters"]["count.chunks"] >= 3


def test_streamed_run_writes_the_pass_and_merge_stages(streamed_job):
    met = streamed_job["metrics"]
    chunks = met["counters"]["count.chunks"]
    assert met["stages_s"]["count/pass"] > 0
    assert met["stages_s"]["count/merge"] > 0
    # the running table and a chunk's table enter each of the chunks - 1
    # merges: the last merge alone holds every row of the whole table,
    # and no table holds more rows than the windows
    merged = met["counters"]["count/merged_rows"]
    windows = 30 * SMALL_BP // 150 * (150 - 31 + 1)
    assert met["counters"]["count.table_rows_k31"] < merged
    assert merged <= 2 * (chunks - 1) * windows
    assert chunks >= 3


def test_streamed_stages_are_profiler_ranges(streamed_job):
    got = streamed_job["ranges"]
    chunks = streamed_job["metrics"]["counters"]["count.chunks"]
    assert got.count("count/pass") == chunks
    assert got.count("count/merge") == chunks - 1


def test_one_pass_count_opens_neither_range():
    rng = np.random.default_rng(5)
    genome = make_genome(rng, 5_000, [], 0.0)
    reads = sample_reads(rng, genome, read_len=150, depth=10,
                         error_rate=0.005)
    lens = np.full(reads.shape[0], 150, np.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        count.count_kmers_auto(reads, lens, k=31, min_cov=2, device="cpu")
    assert _annotations(prof, STREAM_STAGES) == []


@pytest.mark.parametrize("partitions, bits", [
    (1, None), (2, None), (5, None), (3, 20)])
def test_partitioned_count_equals_the_reference(partitions, bits):
    """Exact, and the control's count by a ``bits``-bit fingerprint (at 20
    bits 3% of this input's 68K k-mers share a hash, and 6% more k-mers
    are solid)."""
    rng = np.random.default_rng(2**31 + partitions)
    genome = make_genome(rng, 20_000, [[3, 1610]], 0.002)
    reads = sample_reads(rng, genome, read_len=150, depth=30,
                         error_rate=0.005)
    want_k, want_c = assembly.count(torch.as_tensor(reads), 31, cover=3,
                                    maxcov=10_000_000, fingerprint_bits=bits)
    got_k, got_c = assembly_large.count(reads, 31, cover=3,
                                        maxcov=10_000_000,
                                        partitions=partitions,
                                        block_windows=150_000,
                                        fingerprint_bits=bits)
    assert torch.equal(got_k, want_k) and torch.equal(got_c, want_c)
    assert want_k.shape[0] > 15_000
