#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``reflexiv_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Needs a CUDA card and ``nvcc``; exits non-zero, with no result line, where
``torch.cuda.is_available()`` is False or the package is not beside this
script. Phases, one line each:

  1. card and build: the card's name and power limit (``nvidia-smi``), the
     time to build the CUDA kernels from ``reflexiv_tpu_torch/csrc`` and
     the host IO library from ``native/``;
  2. extraction kernel vs its plain torch version on the main path's read
     matrix (k = 31, and k = 21 with front/end clips 3/2): exactly equal;
  3. radix-sort kernel vs ``torch.sort``, on the main path's keys and on
     2^27 keys with duplicates and a sentinel tail: exactly equal;
  4. the main path at bacterial scale: a random 4,641,652 bp genome (the
     length of E. coli K-12 MG1655, NC_000913.3) from ``--seed``, 100 bp
     reads at 30x with 0.5% substitutions in a FASTQ file, assembled by
     ``reflexiv_tpu_torch.cli.main(["run", ..., "-device", "cuda"])``; both
     kernels' launch counters must be > 0 and the canonical contig total
     within [0.95, 1.05] x the genome;
  5. kernel path vs plain path on the card on a 200 kb genome: the contig
     lists are identical.

Tolerance: every comparison is exact (integer keys, equal contig lists).
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 4_641_652        # E. coli K-12 MG1655 (NC_000913.3)
CHECK_BP = 200_000
READ_LEN, DEPTH, ERR = 100, 30, 0.005
SORT_N = 1 << 27
ACGT = np.frombuffer(b"ACGT", np.uint8)


def say(msg: str) -> None:
    print(msg, flush=True)


def simulate(rng, genome_bp: int):
    """Random genome (2-bit codes) and 100 bp reads at 30x from both
    strands with 0.5% substitutions (a substitution may redraw the same
    base, as tests/test_e2e.py's simulator does)."""
    genome = rng.integers(0, 4, genome_bp, dtype=np.uint8)
    n = DEPTH * genome_bp // READ_LEN
    starts = rng.integers(0, genome_bp - READ_LEN + 1, n)
    reads = genome[starts[:, None] + np.arange(READ_LEN)]
    err = rng.random(reads.shape) < ERR
    reads[err] = rng.integers(0, 4, int(err.sum()), dtype=np.uint8)
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    return genome, reads


def write_fastq(path: str, reads: np.ndarray) -> None:
    n, L = reads.shape
    rec = np.empty((n, 2 * L + 7), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + L] = ACGT[reads]
    rec[:, 3 + L:6 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + L:6 + 2 * L] = ord("I")
    rec[:, 6 + 2 * L] = ord("\n")
    rec.tofile(path)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean milliseconds per call on the card (CUDA events around a train
    of calls, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, name, kernel, plain):
    """Run both, require exact equality, and time them in turns (plain,
    kernel, kernel, plain). Returns (max_abs_err, kernel_ms, plain_ms)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise SystemExit(f"{name}: kernel != plain ({bad} mismatches, "
                         f"shapes {tuple(got.shape)} / {tuple(want.shape)})")
    err = int((got - want).abs().max()) if got.numel() else 0
    del got, want
    p1 = cuda_ms(torch, plain)
    k1 = cuda_ms(torch, kernel)
    k2 = cuda_ms(torch, kernel)
    p2 = cuda_ms(torch, plain)
    return err, (k1 + k2) / 2, (p1 + p2) / 2


def contig_seqs(path: str):
    from reflexiv_tpu_torch.io import iter_fasta

    return [(">" + name, s.decode()) for name, s in iter_fasta([path])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from reflexiv_tpu_torch import cli, count, metrics, native
        from reflexiv_tpu_torch.assembler import (assemble_from_counts,
                                                  assemble_reads)
        from reflexiv_tpu_torch.contigs import assembly_stats, canonical_set
        from reflexiv_tpu_torch.kernels import build, extract, radix_sort
        from reflexiv_tpu_torch.params import Params
    except ImportError as e:
        print(f"chip_smoke: the reflexiv_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(args.seed)

    # 1. card and build
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    build.lib()
    say(f"phase 1 card: {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; kernels built in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {build.last_build_seconds:.2f} s)")
    say(f"nvidia-smi: {smi}")
    # the host FASTQ decoder builds once here, so the run's ingest stage
    # times parsing alone
    t0 = time.perf_counter()
    native_ok = native._get_lib() is not None
    say(f"native IO library {'ready' if native_ok else 'unavailable (Python readers)'}"
        f" in {time.perf_counter() - t0:.2f} s")

    # the main path's input, made once: phases 2-4 use its shapes
    t0 = time.perf_counter()
    genome, reads = simulate(rng, GENOME_BP)
    n_reads = reads.shape[0]
    bases = torch.from_numpy(reads).to(dev)
    lens = torch.full((n_reads,), READ_LEN, dtype=torch.int32, device=dev)
    say(f"input: {GENOME_BP} bp genome, {n_reads} reads x {READ_LEN} bp "
        f"(seed {args.seed}), made in {time.perf_counter() - t0:.1f} s")

    # 2. extraction, kernel vs plain
    rows = {}
    for k, fc, ec in ((31, 0, 0), (21, 3, 2)):
        err, ms, pms = compare(
            torch, f"extract k={k}",
            lambda: extract.extract_canonical_keys(
                bases, lens, k=k, front_clip=fc, end_clip=ec),
            lambda: extract.extract_canonical_keys_torch(
                bases, lens, k=k, front_clip=fc, end_clip=ec))
        say(f"phase 2 extract k={k} clips={fc}/{ec}: {n_reads}x{READ_LEN} "
            f"-> {n_reads * (READ_LEN - k + 1)} keys, equal; kernel "
            f"{ms:.3f} ms, plain {pms:.3f} ms")
        if k == 31:
            rows["extract"] = (err, ms, pms)

    # 3. radix sort, kernel vs torch.sort
    keys31 = extract.extract_canonical_keys(bases, lens, k=31)
    err, ms, pms = compare(
        torch, "sort main-path keys",
        lambda: radix_sort.sort_keys(keys31, bits=62),
        lambda: radix_sort.sort_keys_torch(keys31))
    rows["sort"] = (err, ms, pms)
    say(f"phase 3 sort main-path keys: {keys31.numel()} int64 (k=31, 62 "
        f"bits), equal; kernel {ms:.3f} ms, torch.sort {pms:.3f} ms")
    del keys31
    g = torch.Generator(device=dev).manual_seed(args.seed)
    pool = torch.randint(0, 1 << 62, (1 << 20,), generator=g, device=dev)
    big = pool[torch.randint(0, pool.numel(), (SORT_N,), generator=g,
                             device=dev)]
    big[-SORT_N // 4:] = extract.sentinel(31)
    err2, ms2, pms2 = compare(
        torch, "sort 2^27",
        lambda: radix_sort.sort_keys(big, bits=62),
        lambda: radix_sort.sort_keys_torch(big))
    say(f"phase 3 sort 2^27: {SORT_N} keys (2^20 distinct values, 1/4 "
        f"sentinel tail), equal; kernel {ms2:.3f} ms, torch.sort "
        f"{pms2:.3f} ms")
    del big, pool, bases, lens
    torch.cuda.empty_cache()

    # 4. the main path at bacterial scale
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            prefix="chip_smoke_", dir=os.path.join(REPO, "build")) as work:
        fq = os.path.join(work, "reads.fq")
        write_fastq(fq, reads)
        del reads
        out = os.path.join(work, "asm")
        extract.LAUNCHES = 0
        radix_sort.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(["run", "-fastq", fq, "-kmer", "31", "-cover", "3",
                       "-outfile", out, "-device", "cuda"])
        wall = time.perf_counter() - t0
        launches = {"extract": extract.LAUNCHES, "sort": radix_sort.LAUNCHES}
        if rc != 0:
            raise SystemExit(f"run exited {rc}")
        if min(launches.values()) < 1:
            raise SystemExit(f"main path skipped a kernel: {launches}")
        part = os.path.join(out, "part-00000")
        if not os.path.exists(part):
            raise SystemExit("run wrote no part-00000")
        contigs = contig_seqs(part)
        with open(os.path.join(out, "metrics.json")) as fh:
            met = json.load(fh)
    stats = assembly_stats(contigs)
    share = stats["total_bp"] / GENOME_BP
    gstr = ACGT[genome].tobytes().decode()
    rc_str = ACGT[3 - genome[::-1]].tobytes().decode()
    exact = sum(len(c) for c in canonical_set(contigs)
                if c in gstr or c in rc_str)
    say(f"phase 4 run: {wall:.1f} s wall; contigs {stats['n_contigs']} "
        f"(canonical), total {stats['total_bp']} bp = {share:.4f} x genome, "
        f"longest {stats['longest']}, N50 {stats['n50']}, exact-match bp "
        f"{exact}; launches {launches}; stages_s "
        f"{json.dumps(met['stages_s'])}; counters "
        f"{json.dumps(met['counters'])}")
    if not 0.95 <= share <= 1.05:
        raise SystemExit(f"contig total {stats['total_bp']} bp is "
                         f"{share:.4f} x the genome, outside [0.95, 1.05]")

    # 5. kernel path vs plain path on the card, 200 kb
    _g, small = simulate(np.random.default_rng(args.seed + 1), CHECK_BP)
    slens = np.full(small.shape[0], READ_LEN, np.int32)
    params = Params(k=31, min_kmer_coverage=3)
    metrics.reset()
    t0 = time.perf_counter()
    with_kernels = assemble_reads(small, slens, params, seed=0, device=dev)
    t1 = time.perf_counter()
    keys, counts = count.count_kmers(
        small, slens, k=31, min_cov=3, device=dev, plain=True)
    plain_path = assemble_from_counts(keys, counts, params, seed=0,
                                      device=dev)
    t2 = time.perf_counter()
    if not with_kernels or with_kernels != plain_path:
        raise SystemExit(f"kernel path ({len(with_kernels)} contigs) != "
                         f"plain path ({len(plain_path)} contigs) at 200 kb")
    st = assembly_stats(with_kernels)
    say(f"phase 5 200 kb: kernel path == plain path, {len(with_kernels)} "
        f"contigs, total {st['total_bp']} bp (canonical); {t1 - t0:.1f} s "
        f"vs {t2 - t1:.1f} s")

    src = "reflexiv_tpu_torch/csrc/"
    kernels = [
        {"name": "extract_canonical_keys", "route": "cuda",
         "source": src + "extract_kmers.cu",
         "replaces": "reflexiv_tpu/pallas_kernels.py:30",
         "launches": launches["extract"], "max_abs_err": rows["extract"][0],
         "ms": rows["extract"][1], "plain_ms": rows["extract"][2]},
        {"name": "radix_sort_keys", "route": "cuda",
         "source": src + "radix_sort.cu",
         "replaces": "reflexiv_tpu/sort_kernels.py:167",
         "launches": launches["sort"], "max_abs_err": rows["sort"][0],
         "ms": rows["sort"][1], "plain_ms": rows["sort"][2]},
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
