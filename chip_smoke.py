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
     lists are identical;
  6. the partition probes (``reflexiv_tpu_torch.probes``): the padded
     exchange of 2^24 (hi, lo) pairs and 4096 random 4 KB tile loads, each
     kernel's whole output equal to its plain version;
  7. ``reduce`` at bacterial scale: ``cli.main(["reduce", ...])`` on the
     phase-4 FASTQ with the default klist (23, 31, 41, 53, 67, 81, 95);
     every ``_SUCCESS`` present, and the one-word and W-word kernels both
     launched;
  8. ``reduce`` through the kernels vs through their plain versions on
     the 200 kb genome: every output file byte-identical.

Phases 2 and 3 also hold the W-word extraction and row sort (k = 61, 81
and 95: W = 2, 3 and 4 words) to their plain versions on the main path's
read matrix.

Tolerance: every comparison is exact (integer keys, equal contig lists,
equal files). The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
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
ROW_KS = (61, 81, 95)        # W = 2, 3 and 4 words
ACGT = np.frombuffer(b"ACGT", np.uint8)
HBM_BYTES_S = 3.35e12        # H100 SXM device memory
INT_OPS_S = 67e12            # the card's non-tensor 32-bit peak


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


def compare(torch, name, kernel, plain):
    """Run both, require exact equality (of every tensor, where they return
    tuples), and time them in turns (plain, kernel, kernel, plain).
    Returns (max_abs_err, kernel_ms, plain_ms)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise SystemExit(f"{name}: kernel != plain ({bad} mismatches, "
                             f"shapes {tuple(g.shape)} / {tuple(w.shape)})")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    del got, want, g, w
    from reflexiv_tpu_torch.probes import cuda_ms

    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return err, (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(bytes_moved: float, int_ops: float = 0.0):
    """Least time for the work (ms) and what bounds it: each input byte
    read once and each output byte written once at the card's memory rate,
    against the integer operations at its non-tensor peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, int_ops / INT_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def tree_files(root: str):
    """Relative paths of every file under root but metrics.json."""
    return sorted(os.path.relpath(os.path.join(b, f), root)
                  for b, _d, fs in os.walk(root) for f in fs
                  if f != "metrics.json")


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
        from reflexiv_tpu_torch import native, probes
        from reflexiv_tpu_torch.bitpack import num_words, word_bases
        from reflexiv_tpu_torch.kernels import build, extract, radix_sort
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
    rows, bounds, library = {}, {}, {}
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
            wins = n_reads * (READ_LEN - k + 1)
            bounds["extract"] = bound_ms(
                n_reads * (READ_LEN + 4) + 8 * wins, 8 * wins)
    for k in ROW_KS:
        W = num_words(k)
        err, ms, pms = compare(
            torch, f"extract rows k={k}",
            lambda: extract.extract_canonical_rows(bases, lens, k=k),
            lambda: extract.extract_canonical_rows_torch(bases, lens, k=k))
        wins = n_reads * (READ_LEN - k + 1)
        say(f"phase 2 extract rows k={k} (W={W}): {wins} x {W} words, "
            f"equal; kernel {ms:.3f} ms, plain {pms:.3f} ms")
        rows[f"extract_rows{W}"] = (err, ms, pms)
        bounds[f"extract_rows{W}"] = bound_ms(
            n_reads * (READ_LEN + 4) + 8 * W * wins, 8 * W * wins)

    # 3. radix sort, kernel vs torch.sort
    keys31 = extract.extract_canonical_keys(bases, lens, k=31)
    err, ms, pms = compare(
        torch, "sort main-path keys",
        lambda: radix_sort.sort_keys(keys31, bits=62),
        lambda: radix_sort.sort_keys_torch(keys31))
    rows["sort"] = (err, ms, pms)
    bounds["sort"] = bound_ms(16 * keys31.numel())
    library["sort"] = probes.cuda_ms(lambda: torch.sort(keys31))
    say(f"phase 3 sort main-path keys: {keys31.numel()} int64 (k=31, 62 "
        f"bits), equal; kernel {ms:.3f} ms, torch.sort {pms:.3f} ms")
    del keys31
    for k in ROW_KS:
        W = num_words(k)
        krows = extract.extract_canonical_rows(bases, lens, k=k)
        last = 2 * word_bases(k)[-1]
        err, ms, pms = compare(
            torch, f"sort rows k={k}",
            lambda: radix_sort.sort_rows(krows, last_bits=last),
            lambda: radix_sort.sort_rows_torch(krows))
        rows[f"sort_rows{W}"] = (err, ms, pms)
        bounds[f"sort_rows{W}"] = bound_ms(16 * krows.numel())
        say(f"phase 3 sort rows k={k}: {krows.shape[0]} rows x {W} words, "
            f"equal; kernel {ms:.3f} ms, chained stable torch.sort "
            f"{pms:.3f} ms")
        del krows
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
    launches = {}

    # 4. the main path at bacterial scale
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(REPO, "build"))
    try:
        fq = os.path.join(work, "reads.fq")
        write_fastq(fq, reads)
        del reads
        phases_4_to_8(torch, args, dev, work, fq, genome, launches, rows,
                      bounds, library)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    src = "reflexiv_tpu_torch/csrc/"
    spec = [
        ("extract_canonical_keys", "extract", "extract_kmers.cu",
         "pallas_kernels.py:30"),
        *((f"extract_canonical_rows[W={num_words(k)}]",
           f"extract_rows{num_words(k)}", "extract_kmers.cu",
           "pallas_kernels.py:30") for k in ROW_KS),
        ("radix_sort_keys", "sort", "radix_sort.cu", "sort_kernels.py:167"),
        *((f"radix_sort_rows[W={num_words(k)}]", f"sort_rows{num_words(k)}",
           "radix_sort.cu", "sort_kernels.py:167") for k in ROW_KS),
        ("padded_exchange", "exchange", "partition.cu",
         "partition_kernels.py:67"),
        ("tile_gather", "gather", "partition.cu", "partition_kernels.py:260"),
    ]
    kernels = []
    for name, key, source, replaces in spec:
        err, ms, pms = rows[key]
        bms, by = bounds[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": "reflexiv_tpu/" + replaces,
            "launches": launches.get(key, 0), "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": library.get(key)})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def phases_4_to_8(torch, args, dev, work, fq, genome, launches, rows,
                  bounds, library) -> None:
    """The run, probe and reduce paths, each driven with the launch counts
    set to 0 just before it and read just after; ``launches`` sums them."""
    from reflexiv_tpu_torch import cli, count, metrics, probes
    from reflexiv_tpu_torch.assembler import (assemble_from_counts,
                                              assemble_reads)
    from reflexiv_tpu_torch.bitpack import num_words
    from reflexiv_tpu_torch.contigs import assembly_stats, canonical_set
    from reflexiv_tpu_torch.dynamic import dynamic_reduction
    from reflexiv_tpu_torch.kernels import extract, partition, radix_sort
    from reflexiv_tpu_torch.params import DEFAULT_KLIST, Params

    def tally(path_launches):
        for name, n in path_launches.items():
            launches[name] = launches.get(name, 0) + n

    out = os.path.join(work, "asm")
    extract.LAUNCHES = 0
    radix_sort.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(["run", "-fastq", fq, "-kmer", "31", "-cover", "3",
                   "-outfile", out, "-device", "cuda"])
    wall = time.perf_counter() - t0
    run_launches = {"extract": extract.LAUNCHES, "sort": radix_sort.LAUNCHES}
    if rc != 0:
        raise SystemExit(f"run exited {rc}")
    if min(run_launches.values()) < 1:
        raise SystemExit(f"main path skipped a kernel: {run_launches}")
    tally(run_launches)
    part = os.path.join(out, "part-00000")
    if not os.path.exists(part):
        raise SystemExit("run wrote no part-00000")
    contigs = contig_seqs(part)
    with open(os.path.join(out, "metrics.json")) as fh:
        met = json.load(fh)
    shutil.rmtree(out)
    stats = assembly_stats(contigs)
    share = stats["total_bp"] / GENOME_BP
    gstr = ACGT[genome].tobytes().decode()
    rc_str = ACGT[3 - genome[::-1]].tobytes().decode()
    exact = sum(len(c) for c in canonical_set(contigs)
                if c in gstr or c in rc_str)
    say(f"phase 4 run: {wall:.1f} s wall; contigs {stats['n_contigs']} "
        f"(canonical), total {stats['total_bp']} bp = {share:.4f} x genome, "
        f"longest {stats['longest']}, N50 {stats['n50']}, exact-match bp "
        f"{exact}; launches {run_launches}; stages_s "
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

    # 6. the partition probes
    partition.EXCHANGE_LAUNCHES = 0
    partition.GATHER_LAUNCHES = 0
    ex = probes.partition_exchange_probe(dev, seed=args.seed)
    ga = probes.element_gather_probe(dev, seed=args.seed)
    probe_launches = {"exchange": partition.EXCHANGE_LAUNCHES,
                      "gather": partition.GATHER_LAUNCHES}
    say(f"phase 6 partition_exchange: {json.dumps(ex)}")
    say(f"phase 6 element_gather: {json.dumps(ga)}; launches "
        f"{probe_launches}")
    if not (ex["exact"] and ga["exact"]) or min(probe_launches.values()) < 1:
        raise SystemExit("a partition probe failed its parity or skipped "
                         "its kernel")
    if ex["max_run"] > 1024:
        raise SystemExit(f"max_run {ex['max_run']} > maxrun 1024")
    tally(probe_launches)
    n, block = probes.EXCHANGE_PAIRS, probes.EXCHANGE_BLOCK
    maxrun = probes.EXCHANGE_MAXRUN
    hi_p, lo_p, starts, _hi, _lo = probes.exchange_inputs(dev, args.seed)
    # the wrappers' host check of the table (one device-to-host copy) is
    # made once here; the timed calls skip it
    partition.padded_exchange(hi_p, lo_p, starts, block=block,
                              maxrun=maxrun)
    rows["exchange"] = compare(
        torch, "padded_exchange",
        lambda: partition.padded_exchange(hi_p, lo_p, starts, block=block,
                                          maxrun=maxrun, check=False),
        lambda: partition.padded_exchange_torch(hi_p, lo_p, starts,
                                                block=block, maxrun=maxrun))
    out_words = 2 * 256 * (n // block) * partition.slot_size(maxrun)
    bounds["exchange"] = bound_ms(4 * (2 * (n + maxrun) + starts.numel()
                                       + out_words))
    del hi_p, lo_p, starts, _hi, _lo
    src, tiles = probes.gather_inputs(dev, args.seed)
    partition.tile_gather(src, tiles)
    rows["gather"] = compare(
        torch, "tile_gather",
        lambda: partition.tile_gather(src, tiles, check=False),
        lambda: partition.tile_gather_torch(src, tiles))
    rows_of_src = src.view(-1, partition.TILE)
    tile_idx = (tiles // partition.TILE).to(torch.int64)

    def library_gather():
        return torch.index_select(rows_of_src, 0, tile_idx).view(-1)

    if not torch.equal(library_gather(), partition.tile_gather(src, tiles)):
        raise SystemExit("index_select yardstick != tile_gather")
    library["gather"] = probes.cuda_ms(library_gather, reps=20)
    bounds["gather"] = bound_ms(tiles.numel() * (4 + 2 * 4 * partition.TILE))
    say(f"phase 6 kernels: padded_exchange {rows['exchange'][1]:.3f} ms "
        f"(plain {rows['exchange'][2]:.3f} ms, no one-call library "
        f"counterpart); tile_gather {rows['gather'][1]:.4f} ms (plain "
        f"{rows['gather'][2]:.4f} ms, index_select {library['gather']:.4f} "
        "ms)")
    del src, tiles, rows_of_src, tile_idx
    torch.cuda.empty_cache()

    # 7. reduce at bacterial scale, default klist
    rout = os.path.join(work, "reduce")
    extract.LAUNCHES = 0
    radix_sort.LAUNCHES = 0
    extract.ROW_LAUNCHES.clear()
    radix_sort.ROW_LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["reduce", "-fastq", fq, "-cover", "3", "-outfile", rout,
                   "-device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    red_launches = {"extract": extract.LAUNCHES, "sort": radix_sort.LAUNCHES}
    for W, c in extract.ROW_LAUNCHES.items():
        red_launches[f"extract_rows{W}"] = c
    for W, c in radix_sort.ROW_LAUNCHES.items():
        red_launches[f"sort_rows{W}"] = c
    if rc != 0:
        raise SystemExit(f"reduce exited {rc}")
    want = [f"Count_{k}_{s}" for k in DEFAULT_KLIST
            for s in ("sorted", "reduced")]
    want.append(os.path.join("Stitch_kmer", "Count_31_sorted"))
    missing = [d for d in want
               if not os.path.exists(os.path.join(rout, d, "_SUCCESS"))]
    if missing:
        raise SystemExit(f"reduce left no _SUCCESS in {missing}")
    need = ["extract", "sort"] + [f"{p}{num_words(k)}"
                                  for k in DEFAULT_KLIST if k > 31
                                  for p in ("extract_rows", "sort_rows")]
    if min(red_launches.get(name, 0) for name in need) < 1:
        raise SystemExit(f"reduce skipped a kernel: {red_launches}")
    tally(red_launches)
    with open(os.path.join(rout, "metrics.json")) as fh:
        met = json.load(fh)
    on_disk = sum(os.path.getsize(os.path.join(rout, f))
                  for f in tree_files(rout))
    say(f"phase 7 reduce: {wall:.1f} s wall, peak device memory "
        f"{peak:.2f} GiB, {on_disk} bytes of output; launches "
        f"{json.dumps(red_launches)}; stages_s "
        f"{json.dumps(met['stages_s'])}; counters "
        f"{json.dumps(met['counters'])}")
    shutil.rmtree(rout)

    # 8. reduce, kernel path vs plain path on the card, 200 kb
    sfq = os.path.join(work, "small.fq")
    write_fastq(sfq, small)
    walls = []
    for name, plain in (("kernels", False), ("plain", True)):
        metrics.reset()
        t0 = time.perf_counter()
        dynamic_reduction(Params(min_kmer_coverage=3, input_fastq=sfq,
                                 output_path=os.path.join(work, name)),
                          device=dev, plain=plain)
        walls.append(time.perf_counter() - t0)
    a, b = (os.path.join(work, name) for name in ("kernels", "plain"))
    files = tree_files(a)
    if files != tree_files(b) or not files:
        raise SystemExit("reduce kernel and plain paths wrote other files")
    differ = [f for f in files if not filecmp.cmp(
        os.path.join(a, f), os.path.join(b, f), shallow=False)]
    if differ:
        raise SystemExit(f"reduce outputs differ at 200 kb: {differ}")
    size = sum(os.path.getsize(os.path.join(a, f)) for f in files)
    say(f"phase 8 reduce 200 kb: kernel path == plain path, {len(files)} "
        f"files, {size} bytes, byte-identical; {walls[0]:.1f} s vs "
        f"{walls[1]:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
