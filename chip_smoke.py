#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``reflexiv_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--mesh-walls]

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
     kernel's whole output equal to its plain version; then the tile
     gather, ``index_select`` and the plain gather in interleaved trains of
     200 calls (median of 5 trains), at 4096 tiles from 2^24 words and at
     65,536 tiles from 2^26 words (256 MB each way, past the 50 MB L2);
  7. ``reduce`` at bacterial scale: ``cli.main(["reduce", ...])`` on the
     phase-4 FASTQ with the default klist (23, 31, 41, 53, 67, 81, 95);
     every ``_SUCCESS`` present, and the one-word and W-word kernels both
     launched;
  8. ``reduce`` through the kernels vs through their plain versions on
     the 200 kb genome: every output file byte-identical;
  9. ``meta`` at bacterial scale, run (between phases 7 and 8) on phase
     7's output directory, so it starts from the ``Count_<k>_reduced``
     tables as the ``reduce`` -> ``meta`` contract says:
     ``cli.main(["meta", ..., "-device", "cuda"])``; ``Assembly/_SUCCESS``
     and the ``steps/`` stage directories present, extraction and the
     one-word sort launched (stage 04 indexes the read windows at k = 31
     for end extension, and counts the reads at k = 23 when contigs of
     at most 64 kb go through reassembly), and the
     canonical contig total at least 0.95 x the genome (no upper bound:
     the algorithm's contigs overlap), and rounds of the device-pool loop
     (the default off the TPU); it prints the rounds of each loop form,
     stage 02's split (round joins, census, host splices, the rest) and
     stage 02's own peak device memory;
  9i. phase 9's ``steps/`` up to ``01reduced`` copied into a fresh
     -outfile and ``meta`` run there under ``REFLEXIV_INDEXED_ALWAYS=1``:
     it resumes at stage 02, runs only the summary-indexed loop and
     reaches ``Assembly/_SUCCESS``; both forms' stage 02 walls, host
     splices, rounds and peaks, the canonical total (at least 0.95 x the
     genome) and whether its canonical set equals phase 9's (the forms
     make different joins, so equality is not required);
  10. ``meta`` through the kernels vs through their plain versions on the
     200 kb genome and on a 30 kb one, whose contigs go through read-graph
     reassembly: identical (header, sequence) lists; in three settings:
     the default loop, ``REFLEXIV_INDEXED_ALWAYS=1`` (no device round),
     and ``REFLEXIV_BUCKET_ROUND_ROWS`` at a quarter of the 200 kb stage
     02 pool's rows, so that stage 02 hands its pool from the indexed
     form to the device form on the card (more indexed rounds than the
     default's, and device rounds);
  11. ``-accurate`` and ``-patch``/``-scaffold`` at bacterial scale: a
     paired library of the phase-4 genome (2 x 100 bp reads of 400 +- 40
     bp fragments on a random strand, 30x, 696,247 pairs, 0.5%
     substitutions, two FASTQ files) with 16 planted 30 bp stretches that
     one error-free pair covers between solid margins (what ``-accurate``
     bridges) and 16 uncovered 60 bp gaps that pairs span (what ``-patch``
     links). ``cli.main(["mercy", "-paired", ..., "-kmer", "31"])``: its
     canonical total within [0.95, 1.05] x the genome, extraction and the
     sort launched. ``cli.main(["meta", "-paired", ..., "-accurate",
     "-patch", "-scaffold"])`` from the FASTQ: ``Assembly/_SUCCESS``, at
     least one row in ``04Patching/links.tsv``, at least one N run, mercy
     k-mers rescued at k = 23, 31 and 41 (``mercy/rescued_k<k>``), the
     one-word and every W-word extraction and sort launched, canonical
     total at least 0.95 x the genome, rounds of the device-pool loop; it
     prints the stage split, the loop forms and stage 02 as phase 9 does,
     links, N runs, planted stretches bridged and peak device memory;
  11b. both patching map forms on phase 11's contigs before patching
     (``steps/04contigs``) and its pairs: the native hashed call (the
     default) and the device form (``REFLEXIV_DEVICE_STAGES=1``), their
     ten mapping arrays exactly equal, and both times;
  12. kernel path vs plain path on a 200 kb paired library with 2 planted
     stretches and 2 gaps: ``reduce -accurate`` trees, ``meta -accurate
     -patch -scaffold`` ``Assembly/part-00000`` and ``links.tsv``, and
     ``mercy -kmer 31`` ``part-00000``, byte-identical; then the same
     ``meta`` again from its ``steps/04contigs`` with
     ``REFLEXIV_DEVICE_STAGES=1`` (the device patching map), byte-identical
     to the native map's files;
  13. ``run -kmer 61`` and ``mercy -kmer 41`` on the phase-4 FASTQ: W = 2
     extraction and row sort launched, canonical totals within [0.95,
     1.05] x the genome;
  14. ``preprocess`` on an overlapping paired library of the phase-4
     genome (2 x 100 bp reads of 180 +- 15 bp fragments, 30x, 0.5%
     substitutions whose positions are kept), once with the native
     correction (the default) and once with ``REFLEXIV_DEVICE_STAGES=1``
     (the device correction through the extraction kernel at k = 23): the
     share of pairs merged, bases fixed, substitutions against the truth
     before and after, planted errors removed and bases miscorrected; each
     form must leave fewer substitutions than it found. The extraction
     kernel also meets its plain version on 2^20 candidate segments of 45
     bases;
  15. ``reassembler -kmer 31`` on the phase-4 reads with 1,000 fragments
     of 300-500 bp of the genome (fragments passed through, contigs,
     total), and ``merger`` on the union of phases 4 and 13's contigs (no
     more contigs out than in, each an input contig);
  16. ``stitch`` on the phase-4 reads with phase 4's contigs, the ladder
     21, 31, 61 at full size: per rung the contigs in and out, wall, peak
     device memory and records entering the loop;
  17. counting past the single-pass bound, from disk: a random
     100,286,401 bp genome (the length of C. elegans WBcel235) from
     ``--seed``, 150 bp reads at 30x from both strands with 0.5%
     substitutions (20,057,280 reads, 2,406,873,600 windows at k = 31,
     12% over 2^31), written as FASTQ a slice at a time (about 6.2 GB; the
     work directory needs about 7 GB free). Three child processes, each's
     peak RSS from ``os.wait4``: (a) ``count.count_kmers_from_files``
     under ``REFLEXIV_INGEST_BUDGET_MB=256`` equal to ``count_kmers_auto``
     on the loaded matrix (min_cov 1, every window counted); (b)
     ``python -m reflexiv_tpu_torch.cli run -kmer 31 -cover 3`` under that
     budget; (c) the same ``run`` on the whole matrix. Extraction and the
     sort launch in every leg, (b) and (c) write the same ``part-00000``,
     the canonical total is within [0.95, 1.05] x the genome and (b)'s
     peak RSS is below (c)'s;
  17b. on phase 4's FASTQ: ``count_kmers_from_files`` at
     ``REFLEXIV_INGEST_BUDGET_MB=16`` with an 8M-row device table (at
     least 3 segments spill to the host), ``count_kmers_auto`` with
     ``partitions=8``, and ``count_kmers_from_files_multi`` over the
     default klist (W = 1-4), each table equal to the one-pass
     ``count_kmers`` table;
  and at 200 kb, the kernel path against the plain path: ``run -kmer 61``
  (equal contig lists), ``preprocess`` with the device correction,
  ``reassembler``, ``merger`` and ``stitch`` (byte-identical trees), then
  ``stitch`` over phase 8's ``reduce`` directory (its
  ``Stitch_kmer/Count_31_sorted`` reused); then ``reduce`` and ``meta``
  under a 1 MB budget through the kernels, byte-identical to phases 8 and
  10's whole-matrix plain-path files (the ``reduce`` tree,
  ``Assembly/part-00000`` and ``steps/00sorted``), and end extension with
  its window index in five chunks, equal to one chunk;
  18. ``run`` on a device mesh (``reflexiv_tpu_torch.parallel``): (a)
     phase 4's FASTQ through ``cli.cmd_run`` on one card (warm, for the
     walls) and then with ``mesh=`` 4 virtual shards of ``cuda:0``
     (hash-routed counting, fork passes, rounds and census): the mesh's
     canonical contig set equal to phase 4's, extraction and the sort
     launched once per shard, rounds within 3 of phase 4's; then each
     shard's counting pass holds extraction and the sort to their plain
     versions, and ``count_kmers_sharded`` (min_cov 1) through the
     kernels equals it through the plain versions, shard for shard; (b)
     the 200 kb genome on that mesh, kernel path against plain path,
     identical contig lists; (c) where the machine has several cards,
     ``cli.main(["run", ..., "-device", "cuda:0"])`` and ``"-device",
     "cuda"`` (a mesh over every card) in turns, one, mesh, mesh, one,
     each with phase 4's canonical set and its wall (on one card a line
     says it did not run);
  19. ``meta`` on a device mesh (``meta.assemble_dynamic(..., mesh=)``):
     (a) phase 4's FASTQ through ``cli.cmd_meta`` (``-cover 3``, the
     default klist) on 4 virtual shards of ``cuda:0`` into a fresh
     -outfile, so stage 00 counts and fork-filters every k on the mesh and
     stages 02, 03 and 05 run the mesh loop; its wall, stage laps, rounds,
     peak device memory (the run's and each stage's own) and contig
     figures; the canonical total at least 0.95 x the genome; extraction
     and the sort launched at least 4 times (once a shard) for every k of
     each word count W; then the shard tables of ``count_kmers_sharded``
     at every k of the default klist (W = 1-4) through the kernels equal
     to them through the plain versions; (b) the 200 kb
     genome's ``meta`` and ``meta -accurate`` on that mesh, kernel path
     against plain path, identical ``Assembly/`` trees; (c) under
     ``--mesh-walls`` on a machine with four or more cards, ``meta`` on a
     mesh of four cards byte-identical to 4 virtual shards of ``cuda:0``
     (on one card a line says it did not run);
  20. the process mesh (``reflexiv_tpu_torch.distributed``): (a) 2 gloo
     processes of 2 shards of ``cuda:0`` each (this script run with
     ``--mesh-child``) on phase 4's FASTQ, each feeding its block of the
     read matrix: ``count_kmers_sharded`` at k = 31 and 61, the fork
     records, one packed round and its census, and one mixed-k round on
     the fork records, every output equal shard for shard (sha256 of
     each shard's bytes) to one process over 4 shards of ``cuda:0``;
     extraction and the sort launched in every child (their launches
     join the kernels' line), and in child 0 equal to their plain
     versions on its counting passes; the k = 31 count's wall and its
     exchange time, each child's peak device memory; (b) under
     ``--mesh-walls`` on two or more cards: one NCCL process a card at 2
     and 4 processes, equal to one process over the same cards, then
     ``python -m reflexiv_tpu_torch.multihost_count``'s Mkmers/s at 1, 2
     and 4 processes against one process's ``count_kmers_sharded`` over
     the same cards, in turns (on one card a line says it did not run).
     A child that fails or outlives its 240 s fails the phase.

The script is written for one card: on a machine with several, ``run
-device cuda`` meshes over all of them, so phases 4-17 would take the
mesh. There ``--mesh-walls`` runs phase 1's build, phase 4's input, 18c,
19c and 20b alone.

Phases 2 and 3 also hold the W-word extraction and row sort (k = 61, 81
and 95: W = 2, 3 and 4 words) to their plain versions on the main path's
read matrix. Each extraction and sort line gives its design traffic and
the rate it reached; each extraction line also its share of the bound.

After each group of phases a ``clock:`` line gives the seconds the script
has run so far, so every run shows its margin under its time limit.

Tolerance: every comparison is exact (integer keys, equal contig lists,
equal files). The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 4_641_652        # E. coli K-12 MG1655 (NC_000913.3)
CHECK_BP = 200_000
FRAG_BP = 30_000             # phase 10: contigs under the 64 kb reassembly cap
FRAG_MEAN, FRAG_SD = 400, 40     # phases 11-12: paired fragments
THIN_BP, GAP_BP = 30, 60         # planted single-pair stretches and gaps
N_PLANTED, N_PLANTED_CHECK = 16, 2   # of each, at 4.64 Mbp and at 200 kb
READ_LEN, DEPTH, ERR = 100, 30, 0.005
SORT_N = 1 << 27
ROW_KS = (61, 81, 95)        # W = 2, 3 and 4 words
ACGT = np.frombuffer(b"ACGT", np.uint8)
HBM_BYTES_S = 3.35e12        # H100 SXM device memory
INT_OPS_S = 67e12            # the card's non-tensor 32-bit peak
BIG_GATHER = (1 << 26, 1 << 16)   # (source words, tiles): 256 MB each way


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


def fastq_records(reads: np.ndarray) -> np.ndarray:
    """FASTQ records of a read code matrix, one byte row per read."""
    n, L = reads.shape
    rec = np.empty((n, 2 * L + 7), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + L] = ACGT[reads]
    rec[:, 3 + L:6 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + L:6 + 2 * L] = ord("I")
    rec[:, 6 + 2 * L] = ord("\n")
    return rec


def write_fastq(path: str, reads: np.ndarray) -> None:
    fastq_records(reads).tofile(path)


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


def trains_ms(torch, fns, calls=200, trains=5):
    """Median over ``trains`` of the mean ms per call in a train of
    ``calls`` back-to-back calls. The functions' trains are interleaved,
    in order and in reverse order by turns, after one unrecorded round."""
    times = {name: [] for name in fns}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    names = list(fns)
    for r in range(-1, trains):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            start.record()
            for _ in range(calls):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            if r >= 0:
                times[name].append(start.elapsed_time(end) / calls)
    return {name: float(np.median(t)) for name, t in times.items()}


def sort_traffic(radix_sort, n: int, W: int, last_bits: int) -> int:
    """Design bytes of one sort by its pass plan: the histogram reads
    every word once; a pass reads its key (8 B) and index (4 B, rows), and
    writes its key where the plan says and the index; the last pass of a
    row sort gathers the other W - 1 words and writes the rows."""
    total = 8 * W * n
    for _w, _s, _k, idx_src, _d, flags in radix_sort.pass_plan(W, last_bits):
        total += 8 * n + (4 * n if idx_src >= 0 else 0)
        if flags & radix_sort.WRITE_ROWS:
            total += 8 * (W - 1) * n + 8 * W * n
            continue
        total += 8 * n if flags & radix_sort.WRITE_KEYS else 0
        total += 4 * n if W > 1 else 0
    return total


def bound_ms(bytes_moved: float, int_ops: float = 0.0):
    """Least time for the work (ms) and what bounds it: each input byte
    read once and each output byte written once at the card's memory rate,
    against the integer operations at its non-tensor peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, int_ops / INT_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def path_launches():
    """The launch counters of extraction and the sort, one-word and per W."""
    from reflexiv_tpu_torch.kernels import launch_counts

    return launch_counts()


def zero_launches(extract, radix_sort):
    """Set those counters to 0, just before a main path runs."""
    extract.LAUNCHES = 0
    radix_sort.LAUNCHES = 0
    extract.ROW_LAUNCHES.clear()
    radix_sort.ROW_LAUNCHES.clear()


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
    ap.add_argument("--mesh-walls", action="store_true",
                    help="only phases 18c, 19c and 20b: run on one card and "
                         "on a mesh over every card, in turns; meta on four "
                         "cards against four shards of one; one process "
                         "per card over NCCL against one process over the "
                         "same cards")
    ap.add_argument("--mesh-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    if args.mesh_child:
        return mesh_child(torch, json.loads(args.mesh_child))
    if args.mesh_walls:
        return mesh_walls_only(torch, args)
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

    def extract_line(label, k, ms, pms):
        """Phase 2's figures: design traffic (each code byte and length
        read once, 8 W bytes written per window), its rate and the share
        of the bound the kernel reached."""
        W, wins = num_words(k), n_reads * (READ_LEN - k + 1)
        traffic = n_reads * (READ_LEN + 4) + 8 * W * wins
        bound = bound_ms(traffic, 8 * W * wins)
        say(f"phase 2 {label}: {wins} x {W} words, equal; kernel {ms:.3f} "
            f"ms, plain {pms:.3f} ms; design traffic {traffic / 1e9:.3f} GB,"
            f" {traffic / ms / 1e6:.1f} GB/s; bound {bound[0]:.3f} ms, "
            f"{bound[0] / ms:.0%} of it")
        return bound

    for k, fc, ec in ((31, 0, 0), (21, 3, 2)):
        err, ms, pms = compare(
            torch, f"extract k={k}",
            lambda: extract.extract_canonical_keys(
                bases, lens, k=k, front_clip=fc, end_clip=ec),
            lambda: extract.extract_canonical_keys_torch(
                bases, lens, k=k, front_clip=fc, end_clip=ec))
        bound = extract_line(f"extract k={k} clips={fc}/{ec}", k, ms, pms)
        if k == 31:
            rows["extract"] = (err, ms, pms)
            bounds["extract"] = bound
    for k in ROW_KS:
        W = num_words(k)
        err, ms, pms = compare(
            torch, f"extract rows k={k}",
            lambda: extract.extract_canonical_rows(bases, lens, k=k),
            lambda: extract.extract_canonical_rows_torch(bases, lens, k=k))
        rows[f"extract_rows{W}"] = (err, ms, pms)
        bounds[f"extract_rows{W}"] = extract_line(
            f"extract rows k={k} (W={W})", k, ms, pms)

    # 3. radix sort, kernel vs torch.sort
    keys31 = extract.extract_canonical_keys(bases, lens, k=31)
    err, ms, pms = compare(
        torch, "sort main-path keys",
        lambda: radix_sort.sort_keys(keys31, bits=62),
        lambda: radix_sort.sort_keys_torch(keys31))
    rows["sort"] = (err, ms, pms)
    bounds["sort"] = bound_ms(16 * keys31.numel())
    library["sort"] = probes.cuda_ms(lambda: torch.sort(keys31))
    design = sort_traffic(radix_sort, keys31.numel(), 1, 62)
    say(f"phase 3 sort main-path keys: {keys31.numel()} int64 (k=31, 62 "
        f"bits), equal; kernel {ms:.3f} ms, torch.sort {pms:.3f} ms; bound "
        f"{bounds['sort'][0]:.3f} ms; design traffic {design / 1e9:.3f} GB, "
        f"{design / ms / 1e6:.1f} GB/s")
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
        design = sort_traffic(radix_sort, krows.shape[0], W, last)
        say(f"phase 3 sort rows k={k}: {krows.shape[0]} rows x {W} words, "
            f"equal; kernel {ms:.3f} ms, chained stable torch.sort "
            f"{pms:.3f} ms; bound {bounds[f'sort_rows{W}'][0]:.3f} ms; "
            f"design traffic {design / 1e9:.3f} GB, "
            f"{design / ms / 1e6:.1f} GB/s")
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

        def clock(phases):
            say(f"clock: {time.perf_counter() - t_start:.1f} s of the "
                f"script after phases {phases}")

        clock("1-3")
        rounds4 = phases_4_to_8(torch, args, dev, work, fq, genome,
                                launches, rows, bounds, library)
        clock("4-10")
        phases_11_12(torch, args, dev, work, genome, launches)
        clock("11-12")
        phases_13_16(torch, args, dev, work, fq, genome, launches)
        clock("13-16")
        phase_17(torch, args, work, launches, rows)
        phase_17b(torch, dev, work, fq, launches)
        checks_200kb_streaming(torch, args, dev, work)
        clock("17")
        phase_18(torch, args, work, fq, rounds4, launches, rows)
        clock("18")
        phase_19(torch, args, work, fq, genome, launches)
        clock("19")
        phase_20(torch, work, fq, launches, rows)
        clock("20")
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


def gather_trains(torch, partition, src, tiles, label):
    """Phase 6's tile-gather timing: the kernel and ``index_select`` equal
    to the plain gather, then all three in interleaved trains. Returns the
    kernel's (max_abs_err, ms, plain_ms) and ``index_select``'s ms."""
    partition.tile_gather(src, tiles)   # the host check of the starts, once
    want = partition.tile_gather_torch(src, tiles)
    rows_of_src = src.view(-1, partition.TILE)
    tile_idx = (tiles // partition.TILE).to(torch.int64)
    fns = {
        "tile_gather": lambda: partition.tile_gather(src, tiles, check=False),
        "index_select": lambda: torch.index_select(rows_of_src, 0,
                                                   tile_idx).view(-1),
        "plain": lambda: partition.tile_gather_torch(src, tiles)}
    for name, fn in fns.items():
        if not torch.equal(fn(), want):
            raise SystemExit(f"{name} != plain tile gather ({label} tiles)")
    ms = trains_ms(torch, fns)
    moved = tiles.numel() * 2 * 4 * partition.TILE
    say(f"phase 6 tile_gather {label} tiles: equal; median of 5 trains of "
        f"200 calls (order alternating), ms: " + ", ".join(
            f"{name} {t:.4f} ({moved / t / 1e6:.0f} GB/s)"
            for name, t in ms.items())
        + f"; bound {bound_ms(moved + 4 * tiles.numel())[0]:.4f} ms")
    return (0, ms["tile_gather"], ms["plain"]), ms["index_select"]


def phases_4_to_8(torch, args, dev, work, fq, genome, launches, rows,
                  bounds, library) -> int:
    """The run, probe and reduce paths, each driven with the launch counts
    set to 0 just before it and read just after; ``launches`` sums them.
    Returns phase 4's extension rounds."""
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
    shutil.copy(part, os.path.join(work, "run31.fa"))   # phases 15, 16, 18
    shutil.rmtree(out)
    stats = assembly_stats(contigs)
    share = stats["total_bp"] / GENOME_BP
    gstr = ACGT[genome].tobytes().decode()
    rc_str = ACGT[3 - genome[::-1]].tobytes().decode()
    exact = sum(len(c) for c in canonical_set(contigs)
                if c in gstr or c in rc_str)
    rounds4 = met["counters"]["run/extension_rounds"]
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
    say(f"phase 6 padded_exchange: {rows['exchange'][1]:.3f} ms (plain "
        f"{rows['exchange'][2]:.3f} ms, no one-call library counterpart)")
    src, tiles = probes.gather_inputs(dev, args.seed)
    rows["gather"], library["gather"] = gather_trains(torch, partition, src,
                                                      tiles, "4096")
    bounds["gather"] = bound_ms(tiles.numel() * (4 + 2 * 4 * partition.TILE))
    del src, tiles
    n_src, n_tiles = BIG_GATHER
    g = torch.Generator(device=dev).manual_seed(args.seed)
    src = torch.randint(0, 2**31 - 1, (n_src,), dtype=torch.int32,
                        generator=g, device=dev)
    tiles = (torch.randint(0, n_src // partition.TILE, (n_tiles,),
                           generator=g, device=dev)
             * partition.TILE).to(torch.int32)
    gather_trains(torch, partition, src, tiles, f"{n_tiles}")
    del src, tiles
    torch.cuda.empty_cache()

    # 7. reduce at bacterial scale, default klist
    rout = os.path.join(work, "reduce")
    zero_launches(extract, radix_sort)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["reduce", "-fastq", fq, "-cover", "3", "-outfile", rout,
                   "-device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    red_launches = path_launches()
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
    torch.cuda.empty_cache()
    got9, met9, set9 = meta_phase(torch, cli, fq, rout, genome)
    tally(got9)
    tally(indexed_phase(torch, cli, fq, rout, work, met9, set9))
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

    # 10. meta, kernel path vs plain path on the card: at 200 kb, and at
    # 30 kb, where the contigs are short enough for read-graph reassembly;
    # in the default loop form, under REFLEXIV_INDEXED_ALWAYS=1, and with
    # REFLEXIV_BUCKET_ROUND_ROWS under the 200 kb stage 02 pool, so that
    # stage 02 hands its pool from the indexed form to the device form
    from reflexiv_tpu_torch.meta import dynamic_assembly

    _g, frag = simulate(np.random.default_rng(args.seed + 2), FRAG_BP)
    ffq = os.path.join(work, "frag.fq")
    write_fastq(ffq, frag)
    settings = [("default", {}), ("indexed", {"REFLEXIV_INDEXED_ALWAYS": "1"}),
                ("handoff", None)]
    indexed_default = None
    for setting, env in settings:
        if env is None:
            with open(os.path.join(work, "meta_kernels200kb", "steps",
                                   "01reduced", "meta.json")) as fh:
                rows02 = json.load(fh)["rows"]
            env = {"REFLEXIV_BUCKET_ROUND_ROWS": str(rows02 // 4)}
        os.environ.update(env)
        try:
            for label, path in (("200 kb", sfq), ("30 kb", ffq)):
                walls, lists, fragments, forms = [], [], [], []
                for name, plain in (("meta_kernels", False),
                                    ("meta_plain", True)):
                    out = os.path.join(work, name + label.replace(" ", "")
                                       + setting.replace("default", ""))
                    m = metrics.reset()
                    t0 = time.perf_counter()
                    dynamic_assembly(Params(min_kmer_coverage=3,
                                            input_fastq=path,
                                            output_path=out),
                                     device=dev, plain=plain)
                    walls.append(time.perf_counter() - t0)
                    fragments.append(m.counts.get(
                        "meta/reassembly_fragments", 0))
                    forms.append((m.counts.get("meta/rounds_indexed", 0),
                                  m.counts.get("meta/rounds_device", 0)))
                    lists.append(contig_seqs(os.path.join(
                        out, "Assembly", "part-00000")))
                if not lists[0] or lists[0] != lists[1]:
                    raise SystemExit(
                        f"meta kernel path ({len(lists[0])} contigs) != "
                        f"plain path ({len(lists[1])} contigs) at {label}, "
                        f"{setting} loop")
                if label == "30 kb" and min(fragments) < 1:
                    raise SystemExit(
                        f"meta at 30 kb skipped reassembly: {fragments}")
                (n_ix, n_dev), _ = forms
                if setting == "indexed" and n_dev:
                    raise SystemExit(f"{setting} loop ran device rounds")
                if setting != "indexed" and n_dev < 1:
                    raise SystemExit(f"{setting} loop ran no device round")
                if label == "200 kb" and setting == "default":
                    indexed_default = n_ix
                if label == "200 kb" and setting == "handoff" and \
                        n_ix <= indexed_default:
                    raise SystemExit(
                        f"no handoff in stage 02 under {env}: {n_ix} "
                        f"indexed rounds, {indexed_default} by default")
                st = assembly_stats(lists[0])
                say(f"phase 10 meta {label}, {setting} loop "
                    f"{json.dumps(env)}: kernel path == plain path, "
                    f"{len(lists[0])} contigs, canonical total "
                    f"{st['total_bp']} bp, {fragments[0]} contigs through "
                    f"reassembly; rounds indexed {n_ix}, device {n_dev}; "
                    f"{walls[0]:.1f} s vs {walls[1]:.1f} s")
        finally:
            for var in env:
                del os.environ[var]
    return rounds4


def loop_report(met: dict, steps: str) -> str:
    """Stage 02 of a one-card ``meta`` from its ``metrics.json`` (each
    stage's share of the loop's timers and rounds is ``<stage>.<name>``)
    and its ``steps/``: the rows entering it, its rounds of each loop
    form, its wall split into the round joins, the census, the host
    splices, the pool's conversions in and out and the rest, and its own
    peak device memory."""
    st, c = met["stages_s"], met["counters"]
    with open(os.path.join(steps, "01reduced", "meta.json")) as fh:
        rows = json.load(fh)["rows"]
    names = {"join": "round_join", "census": "round_census",
             "host splices": "round_splice", "pool in": "pool_in",
             "pool out": "pool_out"}
    parts = {name: st.get(f"meta/02extend.{key}", 0.0)
             for name, key in names.items()}
    wall = st.get("meta/02extend", 0.0)
    split = ", ".join(f"{name} {t:.1f}" for name, t in parts.items())
    return (f"{rows} rows into stage 02; its rounds indexed "
            f"{c.get('meta/02extend.rounds_indexed', 0)}, device "
            f"{c.get('meta/02extend.rounds_device', 0)} (whole run "
            f"{c.get('meta/rounds_indexed', 0)} and "
            f"{c.get('meta/rounds_device', 0)}); stage 02 {wall:.1f} s "
            f"({split}, rest {wall - sum(parts.values()):.1f}), own peak "
            f"{c.get('meta/02extend.peak_bytes', 0) / 2**30:.2f} GiB")


def meta_phase(torch, cli, fq, rout, genome):
    """Phase 9: ``meta`` on phase 7's output directory, with the launch
    counts set to 0 just before it. Returns its launches."""
    from reflexiv_tpu_torch.contigs import assembly_stats, canonical_set
    from reflexiv_tpu_torch.kernels import extract, radix_sort

    zero_launches(extract, radix_sort)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["meta", "-fastq", fq, "-cover", "3", "-outfile", rout,
                   "-device", "cuda"])
    wall = time.perf_counter() - t0
    got = path_launches()
    if rc != 0:
        raise SystemExit(f"meta exited {rc}")
    if min(got["extract"], got["sort"]) < 1:
        raise SystemExit(f"meta skipped a kernel: {got}")
    asm = os.path.join(rout, "Assembly")
    missing = [d for d in [asm] + [os.path.join(rout, "steps", s) for s in
                                   ("01reduced", "02extended", "03fixed",
                                    "04contigs")]
               if not os.path.exists(os.path.join(d, "_SUCCESS"))]
    if missing:
        raise SystemExit(f"meta left no _SUCCESS in {missing}")
    contigs = contig_seqs(os.path.join(asm, "part-00000"))
    with open(os.path.join(rout, "metrics.json")) as fh:
        met = json.load(fh)
    # meta restarts the peak counters at every stage: the run's peak is
    # the highest stage's, in metrics.json
    peak = met["counters"]["device/peak_bytes"] / 2**30
    stats = assembly_stats(contigs)
    share = stats["total_bp"] / GENOME_BP
    gstr = ACGT[genome].tobytes().decode()
    rc_str = ACGT[3 - genome[::-1]].tobytes().decode()
    exact = sum(len(c) for c in canonical_set(contigs)
                if c in gstr or c in rc_str)
    say(f"phase 9 meta: {wall:.1f} s wall, peak device memory {peak:.2f} "
        f"GiB; {met['counters'].get('meta/extension_rounds')} extension "
        f"rounds; {loop_report(met, os.path.join(rout, 'steps'))}; contigs "
        f"{stats['n_contigs']} (canonical), total "
        f"{stats['total_bp']} bp = {share:.4f} x genome (redundancy), "
        f"longest {stats['longest']}, N50 {stats['n50']}, exact-match bp "
        f"{exact}; launches {json.dumps(got)}; stages_s "
        f"{json.dumps(met['stages_s'])}; counters "
        f"{json.dumps(met['counters'])}")
    if share < 0.95:
        raise SystemExit(f"meta contig total {stats['total_bp']} bp is "
                         f"{share:.4f} x the genome, under 0.95")
    if met["counters"].get("meta/02extend.rounds_device", 0) < 1:
        raise SystemExit("meta's stage 02 ran no round of the device loop")
    return got, met, canonical_set(contigs)


def indexed_phase(torch, cli, fq, rout, work, met9, set9):
    """Phase 9i: phase 9's ``steps/`` up to ``01reduced`` in a fresh
    -outfile, and ``meta`` there under ``REFLEXIV_INDEXED_ALWAYS=1``: it
    resumes at stage 02 and runs the summary-indexed loop to the end. The
    launch counts are set to 0 just before it; returns its launches."""
    from reflexiv_tpu_torch.contigs import assembly_stats, canonical_set
    from reflexiv_tpu_torch.kernels import extract, radix_sort

    out = os.path.join(work, "meta_indexed")
    steps = os.path.join(out, "steps")
    os.makedirs(steps)
    shutil.copytree(os.path.join(rout, "steps", "01reduced"),
                    os.path.join(steps, "01reduced"))
    shutil.copy(os.path.join(rout, "steps", "params.json"), steps)
    zero_launches(extract, radix_sort)
    os.environ["REFLEXIV_INDEXED_ALWAYS"] = "1"
    try:
        t0 = time.perf_counter()
        rc = cli.main(["meta", "-fastq", fq, "-cover", "3", "-outfile", out,
                       "-device", "cuda"])
        wall = time.perf_counter() - t0
    finally:
        del os.environ["REFLEXIV_INDEXED_ALWAYS"]
    got = path_launches()
    if rc != 0:
        raise SystemExit(f"meta under REFLEXIV_INDEXED_ALWAYS=1 exited {rc}")
    with open(os.path.join(out, "metrics.json")) as fh:
        met = json.load(fh)
    st, c = met["stages_s"], met["counters"]
    if "meta/01reduce" in st or "meta/02extend" not in st:
        raise SystemExit(f"phase 9i did not resume at stage 02: {st}")
    if c.get("meta/rounds_device", 0) or not c.get("meta/rounds_indexed"):
        raise SystemExit(f"phase 9i left the indexed loop: {c}")
    if not os.path.exists(os.path.join(out, "Assembly", "_SUCCESS")):
        raise SystemExit("phase 9i left no Assembly/_SUCCESS")
    contigs = contig_seqs(os.path.join(out, "Assembly", "part-00000"))
    stats = assembly_stats(contigs)
    share = stats["total_bp"] / GENOME_BP
    same = canonical_set(contigs) == set9
    say(f"phase 9i meta resumed at stage 02, REFLEXIV_INDEXED_ALWAYS=1: "
        f"{wall:.1f} s wall; indexed {loop_report(met, steps)}; device "
        f"(phase 9) {loop_report(met9, steps)}; contigs "
        f"{stats['n_contigs']} (canonical), "
        f"total {stats['total_bp']} bp = {share:.4f} x genome, N50 "
        f"{stats['n50']}; canonical set equal to phase 9's: {same}; "
        f"launches {json.dumps(got)}; stages_s {json.dumps(st)}")
    if share < 0.95:
        raise SystemExit(f"phase 9i contig total is {share:.4f} x the "
                         "genome, under 0.95")
    shutil.rmtree(out)
    return got



# ---------------------------------------------------------------------------
# phases 11-12: -accurate and -patch/-scaffold on paired libraries
# ---------------------------------------------------------------------------

def planted(genome_bp: int, n_each: int):
    """Evenly spaced, alternating (lo, hi) of ``n_each`` thin stretches
    and ``n_each`` gaps."""
    step = genome_bp // (2 * n_each + 1)
    thin = [((2 * i + 1) * step, (2 * i + 1) * step + THIN_BP)
            for i in range(n_each)]
    gaps = [((2 * i + 2) * step, (2 * i + 2) * step + GAP_BP)
            for i in range(n_each)]
    return thin, gaps


def simulate_pairs(rng, genome: np.ndarray, thin, gaps):
    """Mate code matrices of a paired library at DEPTH x: fragments of
    FRAG_MEAN +- FRAG_SD bp on a random strand, ERR substitutions. No read
    touches a planted region, but fragments span them; each thin stretch
    gets four error-free pairs ending at each of its sides (solid margins,
    as tests/test_e2e.py:204 builds them) and one error-free pair whose
    first mate covers it."""
    G, L = len(genome), READ_LEN
    n = DEPTH * G // (2 * L)
    regions = np.asarray(sorted(thin + gaps), np.int64)

    def clear(a):
        i = np.searchsorted(regions[:, 0], a + L) - 1
        return (i < 0) | (regions[np.maximum(i, 0), 1] <= a)

    extra = [s for lo, hi in thin for off in (0, 3, 6, 9)
             for s in (lo - L - off, hi + off)]
    extra += [(lo + hi - L) // 2 for lo, hi in thin]
    n_reg = n - len(extra)
    starts, ins = [], []
    while sum(len(x) for x in starts) < n_reg:
        m = n_reg + 1000
        frag = np.maximum(np.rint(rng.normal(FRAG_MEAN, FRAG_SD, m))
                          .astype(np.int64), 2 * L)
        s = (rng.random(m) * (G - frag + 1)).astype(np.int64)
        ok = clear(s) & clear(s + frag - L)
        starts.append(s[ok])
        ins.append(frag[ok])
    starts = np.concatenate(starts)[:n_reg]
    ins = np.concatenate(ins)[:n_reg]
    cols = np.arange(L)
    m1 = genome[starts[:, None] + cols]
    m2 = 3 - genome[(starts + ins - L)[:, None] + cols][:, ::-1]
    for m in (m1, m2):
        err = rng.random(m.shape) < ERR
        m[err] = rng.integers(0, 4, int(err.sum()), dtype=np.uint8)
    flip = rng.random(n_reg) < 0.5
    m1[flip], m2[flip] = m2[flip].copy(), m1[flip].copy()
    ex = np.asarray(extra, np.int64)
    e1 = genome[ex[:, None] + cols]
    e2 = 3 - genome[(ex + FRAG_MEAN - L)[:, None] + cols][:, ::-1]
    return np.concatenate([m1, e1]), np.concatenate([m2, e2])


def write_pairs(work: str, name: str, m1, m2) -> str:
    """Two FASTQ files; returns the ``-paired`` argument."""
    paths = [os.path.join(work, f"{name}_{j}.fq") for j in (1, 2)]
    for path, m in zip(paths, (m1, m2)):
        write_fastq(path, m)
    return ",".join(paths)


def phases_11_12(torch, args, dev, work, genome, launches) -> None:
    """Phases 11, 11b and 12; ``launches`` sums the launches of phase
    11's two main-path runs, each counted from 0."""
    from reflexiv_tpu_torch import checkpoint, cli, metrics, patching
    from reflexiv_tpu_torch.bitpack import num_words
    from reflexiv_tpu_torch.contigs import (assembly_stats, canonical_set,
                                            revcomp_str)
    from reflexiv_tpu_torch.kernels import extract, radix_sort
    from reflexiv_tpu_torch.params import DEFAULT_KLIST, Params

    # 11. the paired library at bacterial scale
    t0 = time.perf_counter()
    thin, gaps = planted(GENOME_BP, N_PLANTED)
    m1, m2 = simulate_pairs(np.random.default_rng(args.seed + 3), genome,
                            thin, gaps)
    paired = write_pairs(work, "pairs", m1, m2)
    n_pairs = len(m1)
    del m1, m2
    say(f"phase 11 input: {n_pairs} pairs of 2 x {READ_LEN} bp, fragments "
        f"{FRAG_MEAN} +- {FRAG_SD} bp, {N_PLANTED} thin stretches of "
        f"{THIN_BP} bp and {N_PLANTED} gaps of {GAP_BP} bp, made in "
        f"{time.perf_counter() - t0:.1f} s")
    gstr = ACGT[genome].tobytes().decode()

    out = os.path.join(work, "mercy")
    zero_launches(extract, radix_sort)
    t0 = time.perf_counter()
    rc = cli.main(["mercy", "-paired", paired, "-kmer", "31", "-cover", "3",
                   "-outfile", out, "-device", "cuda"])
    wall = time.perf_counter() - t0
    got = path_launches()
    if rc != 0:
        raise SystemExit(f"mercy exited {rc}")
    if min(got["extract"], got["sort"]) < 1:
        raise SystemExit(f"mercy skipped a kernel: {got}")
    for name, c in got.items():
        launches[name] = launches.get(name, 0) + c
    contigs = contig_seqs(os.path.join(out, "part-00000"))
    with open(os.path.join(out, "metrics.json")) as fh:
        met = json.load(fh)
    shutil.rmtree(out)
    st = assembly_stats(contigs)
    share = st["total_bp"] / GENOME_BP
    say(f"phase 11 mercy -kmer 31: {wall:.1f} s wall; contigs "
        f"{st['n_contigs']} (canonical), total {st['total_bp']} bp = "
        f"{share:.4f} x genome, N50 {st['n50']}; launches {json.dumps(got)};"
        f" stages_s {json.dumps(met['stages_s'])}; counters "
        f"{json.dumps(met['counters'])}")
    if not 0.95 <= share <= 1.05:
        raise SystemExit(f"mercy contig total is {share:.4f} x the genome, "
                         "outside [0.95, 1.05]")

    out = os.path.join(work, "meta_paired")
    zero_launches(extract, radix_sort)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["meta", "-paired", paired, "-cover", "3", "-accurate",
                   "-patch", "-scaffold", "-outfile", out, "-device",
                   "cuda"])
    wall = time.perf_counter() - t0
    got = path_launches()
    if rc != 0:
        raise SystemExit(f"meta -accurate -patch -scaffold exited {rc}")
    need = ["extract", "sort"] + sorted({
        f"{p}{num_words(k)}" for k in DEFAULT_KLIST if k > 31
        for p in ("extract_rows", "sort_rows")})
    if min(got.get(name, 0) for name in need) < 1:
        raise SystemExit(f"meta -accurate skipped a kernel: {got}")
    for name, c in got.items():
        launches[name] = launches.get(name, 0) + c
    asm = os.path.join(out, "Assembly")
    lpath = os.path.join(out, "04Patching", "links.tsv")
    if not os.path.exists(os.path.join(asm, "_SUCCESS")):
        raise SystemExit("meta -patch left no Assembly/_SUCCESS")
    if not os.path.exists(lpath):
        raise SystemExit("meta -patch wrote no 04Patching/links.tsv")
    with open(lpath) as fh:
        n_links = len(fh.read().splitlines()) - 1
    with open(os.path.join(out, "metrics.json")) as fh:
        met = json.load(fh)
    peak = met["counters"]["device/peak_bytes"] / 2**30
    contigs = contig_seqs(os.path.join(asm, "part-00000"))
    st = assembly_stats(contigs)
    share = st["total_bp"] / GENOME_BP
    seqs = [s for _h, s in contigs]
    n_runs = sum(len(re.findall("N+", s)) for s in seqs)
    joined = "|".join(seqs)
    probes = [gstr[lo - 40:hi + 40] for lo, hi in thin]
    bridged = sum(p in joined or revcomp_str(p) in joined for p in probes)
    rescued = {k: met["counters"].get(f"mercy/rescued_k{k}", 0)
               for k in DEFAULT_KLIST}
    say(f"phase 11 meta -accurate -patch -scaffold: {wall:.1f} s wall, peak "
        f"device memory {peak:.2f} GiB; {n_links} links, {n_runs} N runs, "
        f"{bridged} of {N_PLANTED} thin stretches bridged; contigs "
        f"{st['n_contigs']} (canonical), total {st['total_bp']} bp = "
        f"{share:.4f} x genome, longest {st['longest']}, N50 {st['n50']}; "
        f"mercy k-mers rescued {json.dumps(rescued)}; "
        f"{loop_report(met, os.path.join(out, 'steps'))}; "
        f"launches {json.dumps(got)}; stages_s "
        f"{json.dumps(met['stages_s'])}; counters "
        f"{json.dumps(met['counters'])}")
    if n_links < 1 or n_runs < 1:
        raise SystemExit(f"meta -patch -scaffold: {n_links} links, {n_runs} "
                         "N runs; needs at least one of each")
    if min(rescued[k] for k in (23, 31, 41)) < 1:
        raise SystemExit(f"no mercy k-mer rescued at some k: {rescued}")
    if share < 0.95:
        raise SystemExit(f"meta contig total is {share:.4f} x the genome, "
                         "under 0.95")
    if met["counters"].get("meta/02extend.rounds_device", 0) < 1:
        raise SystemExit("meta -accurate's stage 02 ran no round of the "
                         "device loop")

    # 11b. the two patching map forms on phase 11's contigs and pairs
    steps = os.path.join(out, "steps")
    pre = [s for s, _l, _r in checkpoint.load_contigs_attrs(steps,
                                                            "04contigs")]
    pairs = patching.read_pairs_from_params(Params(input_fastq=paired))
    times, maps = [], []
    for form in ("native", "device"):
        if form == "device":
            os.environ["REFLEXIV_DEVICE_STAGES"] = "1"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            maps.append(patching.map_pairs(pre, pairs, device=dev))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        finally:
            os.environ.pop("REFLEXIV_DEVICE_STAGES", None)
    (a, la), (b, lb) = maps
    if not (np.array_equal(la, lb) and all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(a, b))):
        raise SystemExit("patching map: device form != native hashed form")
    say(f"phase 11b patching map on {len(pre)} contigs and {len(pairs)} "
        f"pairs: the ten arrays equal; native hashed {times[0]:.2f} s, "
        f"device form {times[1]:.2f} s (end index, matrices and map); "
        f"{int(a[4].sum())} + {int(a[9].sum())} mates mapped")
    del pairs, maps, a, b
    shutil.rmtree(out)
    os.remove(paired.split(",")[0])
    os.remove(paired.split(",")[1])
    torch.cuda.empty_cache()

    # 12. kernel path vs plain path on a 200 kb paired library
    from reflexiv_tpu_torch.dynamic import dynamic_reduction
    from reflexiv_tpu_torch.meta import dynamic_assembly
    from reflexiv_tpu_torch.mercy import mercy_assembly

    rng = np.random.default_rng(args.seed + 4)
    small = rng.integers(0, 4, CHECK_BP, dtype=np.uint8)
    thin, gaps = planted(CHECK_BP, N_PLANTED_CHECK)
    spaired = write_pairs(work, "small_pairs",
                          *simulate_pairs(rng, small, thin, gaps))
    checks = (
        ("reduce -accurate", dynamic_reduction,
         dict(min_kmer_coverage=3, sensitive=True), None),
        ("meta -accurate -patch -scaffold", dynamic_assembly,
         dict(min_kmer_coverage=3, sensitive=True, patch=True,
              scaffold=True),
         ["Assembly/part-00000", "04Patching/links.tsv"]),
        ("mercy -kmer 31", mercy_assembly,
         dict(k=31, min_kmer_coverage=3), ["part-00000"]),
    )
    for label, entry, kw, files in checks:
        walls, dirs = [], []
        for name, plain in (("kernels", False), ("plain", True)):
            d = os.path.join(work, f"p12_{label.split()[0]}_{name}")
            metrics.reset()
            t0 = time.perf_counter()
            entry(Params(input_fastq=spaired, output_path=d, **kw),
                   device=dev, plain=plain)
            walls.append(time.perf_counter() - t0)
            dirs.append(d)
        names = files or tree_files(dirs[0])
        if files is None and names != tree_files(dirs[1]):
            raise SystemExit(f"{label}: kernel and plain paths wrote other "
                             "files")
        missing = [f for f in names
                   if not os.path.exists(os.path.join(dirs[0], f))]
        differ = [f for f in names if f not in missing and not filecmp.cmp(
            os.path.join(dirs[0], f), os.path.join(dirs[1], f),
            shallow=False)]
        if missing or differ or not names:
            raise SystemExit(f"{label} at {CHECK_BP} bp: missing {missing}, "
                             f"differ {differ}")
        say(f"phase 12 {label} {CHECK_BP // 1000} kb: kernel path == plain "
            f"path, {len(names)} files byte-identical; {walls[0]:.1f} s vs "
            f"{walls[1]:.1f} s")
    # the same meta run again from its 04contigs, the map on the device
    src = os.path.join(work, "p12_meta_kernels")
    dst = os.path.join(work, "p12_meta_device_map")
    shutil.copytree(os.path.join(src, "steps"), os.path.join(dst, "steps"))
    os.environ["REFLEXIV_DEVICE_STAGES"] = "1"
    try:
        metrics.reset()
        dynamic_assembly(Params(input_fastq=spaired, output_path=dst,
                                **checks[1][2]), device=dev)
    finally:
        os.environ.pop("REFLEXIV_DEVICE_STAGES", None)
    differ = [f for f in checks[1][3] if not filecmp.cmp(
        os.path.join(src, f), os.path.join(dst, f), shallow=False)]
    if differ:
        raise SystemExit(f"meta -patch with the device map differs: {differ}")
    say("phase 12 meta -patch, REFLEXIV_DEVICE_STAGES=1 vs the native map: "
        "Assembly/part-00000 and links.tsv byte-identical")



# ---------------------------------------------------------------------------
# phases 13-16: run and mercy above k = 31, preprocess, reassembler and
# merger, stitch
# ---------------------------------------------------------------------------

PRE_FRAG_MEAN, PRE_FRAG_SD = 180, 15   # phase 14: mates overlap
N_REASSEMBLY_FRAGS, N_REASSEMBLY_FRAGS_CHECK = 1000, 40   # 300-500 bp


def simulate_overlapping_pairs(rng, genome: np.ndarray):
    """Phase 14's library at DEPTH x: fragments of PRE_FRAG_MEAN +-
    PRE_FRAG_SD bp (longer than READ_LEN) on a random strand, read from both
    ends by READ_LEN bp mates, with ERR substitutions (each to another
    base). Returns the mates, the fragments (rows of the widest's width,
    zero past each length) and their lengths."""
    G, L = len(genome), READ_LEN
    n = DEPTH * G // (2 * L)
    ins = np.maximum(np.rint(rng.normal(PRE_FRAG_MEAN, PRE_FRAG_SD, n))
                     .astype(np.int64), L + 1)
    s = (rng.random(n) * (G - ins + 1)).astype(np.int64)
    W = int(ins.max())
    cols = np.arange(W)
    past = cols[None, :] >= ins[:, None]
    frag = genome[np.minimum(s[:, None] + cols, G - 1)]
    frag[past] = 0
    flip = rng.random(n) < 0.5
    rc = 3 - frag[np.arange(n)[:, None],
                  np.clip(ins[:, None] - 1 - cols, 0, W - 1)]
    rc[past] = 0
    frag[flip] = rc[flip]
    del rc, past
    m1 = frag[:, :L].copy()
    m2 = 3 - frag[np.arange(n)[:, None],
                  ins[:, None] - 1 - np.arange(L)[None, :]]
    for m in (m1, m2):
        err = rng.random(m.shape) < ERR
        m[err] = (m[err] + rng.integers(1, 4, int(err.sum()))) % 4
    return m1, m2, frag, ins


def substitution_counts(before_fq: str, after_fq: str, frag, ins):
    """Phase 14's quality numbers from preprocess's two FASTQ files, in
    the same read order: a pair merged into one read (longer than
    READ_LEN) or its two mates (mate 2 reverse complemented). Each read is
    held against its fragment; a read merged at another length than its
    fragment's has no truth and is left out. Returns the substitutions
    found before correction, left after, removed (wrong before, right
    after), miscorrected (right before, wrong after) and the reads left
    out."""
    from reflexiv_tpu_torch.io import load_reads

    before, lens = load_reads(before_fq)
    after, lens2 = load_reads(after_fq)
    if not np.array_equal(lens, lens2) or before.shape != after.shape:
        raise SystemExit("preprocess: corrected reads differ in length")
    units = np.where(lens != READ_LEN, 2, 1)
    prefix = np.cumsum(units) - units
    if prefix[-1] + units[-1] != 2 * len(ins):
        raise SystemExit("preprocess: reads do not split into the pairs")
    pair = prefix // 2
    second = (units == 1) & (prefix % 2 == 1)
    start = np.where(second, ins[pair] - READ_LEN, 0)
    known = (units == 1) | (lens == ins[pair])
    cols = np.arange(before.shape[1])
    inside = (cols[None, :] < lens[:, None]) & known[:, None]
    truth = frag[pair[:, None], np.minimum(start[:, None] + cols,
                                           frag.shape[1] - 1)]
    wrong_b = (before != truth) & inside
    wrong_a = (after != truth) & inside
    return (int(wrong_b.sum()), int(wrong_a.sum()),
            int((wrong_b & ~wrong_a).sum()), int((~wrong_b & wrong_a).sum()),
            int((~known).sum()))


def sample_fragments(rng, genome: np.ndarray, n: int):
    """n substrings of 300-500 bp of the genome on a random strand."""
    out = []
    for _ in range(n):
        ln = int(rng.integers(300, 501))
        s = int(rng.integers(0, len(genome) - ln + 1))
        f = genome[s:s + ln]
        out.append(ACGT[3 - f[::-1] if rng.random() < 0.5 else f]
                   .tobytes().decode())
    return out


def write_fasta(path: str, seqs) -> None:
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">f{i}\n{s}\n")


def run_cli(torch, cli, argv, label):
    """``cli.main(argv)`` with the launch counts and the device memory
    peak set to 0 just before; returns (wall, peak GiB as metrics.json's
    ``device/peak_bytes`` has it, launches, metrics.json)."""
    from reflexiv_tpu_torch.kernels import extract, radix_sort

    zero_launches(extract, radix_sort)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["-device", "cuda"])
    wall = time.perf_counter() - t0
    got = path_launches()
    if rc != 0:
        raise SystemExit(f"{label} exited {rc}")
    out = argv[argv.index("-outfile") + 1]
    with open(os.path.join(out, "metrics.json")) as fh:
        met = json.load(fh)
    return wall, met["counters"]["device/peak_bytes"] / 2**30, got, met


def genome_share(contigs, genome):
    from reflexiv_tpu_torch.contigs import assembly_stats

    st = assembly_stats(contigs)
    return st, st["total_bp"] / len(genome)


def phases_13_16(torch, args, dev, work, fq, genome, launches) -> None:
    """Phases 13-16 and their 200 kb kernel-vs-plain checks; ``launches``
    sums the launches of the main-path runs, each counted from 0."""
    from reflexiv_tpu_torch import cli
    from reflexiv_tpu_torch.kernels import extract

    def tally(got):
        for name, c in got.items():
            launches[name] = launches.get(name, 0) + c

    # 13. run -kmer 61 and mercy -kmer 41
    for cmd, k in (("run", 61), ("mercy", 41)):
        out = os.path.join(work, f"{cmd}{k}")
        wall, peak, got, met = run_cli(
            torch, cli, [cmd, "-fastq", fq, "-kmer", str(k), "-cover", "3",
                         "-outfile", out], f"{cmd} -kmer {k}")
        if min(got.get("extract_rows2", 0), got.get("sort_rows2", 0)) < 1:
            raise SystemExit(f"{cmd} -kmer {k} skipped a W = 2 kernel: {got}")
        tally(got)
        contigs = contig_seqs(os.path.join(out, "part-00000"))
        st, share = genome_share(contigs, genome)
        say(f"phase 13 {cmd} -kmer {k}: {wall:.1f} s wall, peak device "
            f"memory {peak:.2f} GiB; contigs {st['n_contigs']} (canonical),"
            f" total {st['total_bp']} bp = {share:.4f} x genome, N50 "
            f"{st['n50']}; launches {json.dumps(got)}; stages_s "
            f"{json.dumps(met['stages_s'])}")
        if not 0.95 <= share <= 1.05:
            raise SystemExit(f"{cmd} -kmer {k}: total {share:.4f} x the "
                             "genome, outside [0.95, 1.05]")
        if cmd == "run":
            shutil.copy(os.path.join(out, "part-00000"),
                        os.path.join(work, "run61.fa"))
        shutil.rmtree(out)

    # 14. preprocess on an overlapping paired library, both correction forms
    t0 = time.perf_counter()
    m1, m2, frag, ins = simulate_overlapping_pairs(
        np.random.default_rng(args.seed + 5), genome)
    pre_pairs = write_pairs(work, "pre_pairs", m1, m2)
    say(f"phase 14 input: {len(ins)} pairs of 2 x {READ_LEN} bp, fragments "
        f"{PRE_FRAG_MEAN} +- {PRE_FRAG_SD} bp, {ERR} substitutions, made in "
        f"{time.perf_counter() - t0:.1f} s")
    del m1, m2
    seg_checked = False
    for form, env in (("native", None), ("device", "1")):
        out = os.path.join(work, f"pre_{form}")
        if env:
            os.environ["REFLEXIV_DEVICE_STAGES"] = env
        try:
            wall, peak, got, met = run_cli(
                torch, cli, ["preprocess", "-fastq", pre_pairs, "-outfile",
                             out], f"preprocess ({form})")
        finally:
            os.environ.pop("REFLEXIV_DEVICE_STAGES", None)
        if min(got["extract"], got["sort"]) < 1:
            raise SystemExit(f"preprocess ({form}) skipped a kernel: {got}")
        tally(got)
        c = met["counters"]
        found, left, removed, mis, unknown = substitution_counts(
            os.path.join(out, "Read_Paired_Merged", "part-00000.fq"),
            os.path.join(out, "Read_Repartitioned", "part-00000.fq"),
            frag, ins)
        say(f"phase 14 preprocess, {form} correction: {wall:.1f} s wall, "
            f"peak device memory {peak:.2f} GiB; pairs merged "
            f"{c['preprocess/pairs_merged']} of {c['preprocess/pairs']} = "
            f"{c['preprocess/pairs_merged'] / c['preprocess/pairs']:.4f}; "
            f"bases fixed {c['preprocess/bases_fixed']}; substitutions "
            f"{found} before, {left} after; planted removed {removed}, "
            f"miscorrected {mis} ({unknown} reads merged off their fragment "
            f"length, not scored); launches {json.dumps(got)}; stages_s "
            f"{json.dumps(met['stages_s'])}")
        if not left < found:
            raise SystemExit(f"preprocess ({form}): {left} substitutions "
                             f"left of {found}")
        if not seg_checked:
            # the device form's candidate segments: (N, 2k-1) at k = 23
            from reflexiv_tpu_torch.io import load_reads

            mat, lens = load_reads(os.path.join(out, "Read_Repartitioned",
                                                "part-00000.fq"))
            g = np.random.default_rng(args.seed)
            r = g.integers(0, len(lens), 1 << 20)
            p = 22 + (g.random(1 << 20) * (lens[r] - 44)).astype(np.int64)
            seg = torch.from_numpy(mat[r[:, None], p[:, None]
                                       + np.arange(-22, 23)]).to(dev)
            slens = torch.full((seg.shape[0],), 45, dtype=torch.int32,
                               device=dev)
            err, ms, pms = compare(
                torch, "extract k=23 segments",
                lambda: extract.extract_canonical_keys(seg, slens, k=23),
                lambda: extract.extract_canonical_keys_torch(seg, slens,
                                                             k=23))
            say(f"phase 14 extract k=23 on {seg.shape[0]} candidate "
                f"segments of 45 bases: equal; kernel {ms:.3f} ms, plain "
                f"{pms:.3f} ms")
            del seg, slens, mat
            seg_checked = True
        shutil.rmtree(out)
    del frag, ins
    torch.cuda.empty_cache()

    # 15. reassembler with 1,000 fragments; merger on phases 4 and 13
    frags = os.path.join(work, "frags.fa")
    write_fasta(frags, sample_fragments(np.random.default_rng(args.seed + 6),
                                        genome, N_REASSEMBLY_FRAGS))
    out = os.path.join(work, "reassembler")
    wall, peak, got, met = run_cli(
        torch, cli, ["reassembler", "-fastq", fq, "-frag", frags, "-kmer",
                     "31", "-cover", "3", "-outfile", out], "reassembler")
    if min(got["extract"], got["sort"]) < 1:
        raise SystemExit(f"reassembler skipped a kernel: {got}")
    tally(got)
    contigs = contig_seqs(os.path.join(out, "Assemble_31", "part-00000"))
    st, share = genome_share(contigs, genome)
    say(f"phase 15 reassembler -kmer 31, {N_REASSEMBLY_FRAGS} fragments of "
        f"300-500 bp: {wall:.1f} s wall, peak device memory {peak:.2f} GiB;"
        f" {met['counters'].get('reassemble/passthrough')} passed through;"
        f" contigs {len(contigs)} ({st['n_contigs']} canonical), total "
        f"{st['total_bp']} bp = {share:.4f} x genome, N50 {st['n50']}; "
        f"launches {json.dumps(got)}; stages_s {json.dumps(met['stages_s'])}")
    shutil.rmtree(out)
    union = [s for f in ("run31.fa", "run61.fa")
             for _h, s in contig_seqs(os.path.join(work, f))]
    ufa = os.path.join(work, "union.fa")
    write_fasta(ufa, union)
    out = os.path.join(work, "merger")
    t0 = time.perf_counter()
    if cli.main(["merger", "-fasta", ufa, "-outfile", out]) != 0:
        raise SystemExit("merger failed")
    wall = time.perf_counter() - t0
    merged = [s for _h, s in contig_seqs(os.path.join(out, "Merged",
                                                      "part-00000"))]
    if len(merged) > len(union) or not set(merged) <= set(union):
        raise SystemExit(f"merger: {len(merged)} contigs out of "
                         f"{len(union)}, or one not among them")
    say(f"phase 15 merger on phases 4 and 13's contigs: {len(union)} -> "
        f"{len(merged)} contigs, each an input contig; {wall:.1f} s wall")
    shutil.rmtree(out)

    # 16. stitch at full size, then once over a reduce directory
    out = os.path.join(work, "stitch")
    n_in = len(contig_seqs(os.path.join(work, "run31.fa")))
    wall, peak, got, met = run_cli(
        torch, cli, ["stitch", "-fastq", fq, "-frag",
                     os.path.join(work, "run31.fa"), "-outfile", out],
        "stitch")
    if min(got["extract"], got["sort"], got.get("extract_rows2", 0),
           got.get("sort_rows2", 0)) < 1:
        raise SystemExit(f"stitch skipped a kernel: {got}")
    tally(got)
    c, t = met["counters"], met["stages_s"]
    for k in (21, 31, 61):
        say(f"phase 16 stitch rung k={k}: contigs in {n_in}, out "
            f"{c[f'stitch/contigs_k{k}']}; {t[f'stitch/k{k}']:.1f} s; "
            f"{c[f'stitch/records_k{k}']} records entering the loop; peak "
            f"device memory so far "
            f"{c.get(f'stitch/peak_bytes_k{k}', 0) / 2**30:.2f} GiB")
        n_in = c[f"stitch/contigs_k{k}"]
    contigs = contig_seqs(os.path.join(out, "Assembly_stitched_61",
                                       "part-00000"))
    st, share = genome_share(contigs, genome)
    say(f"phase 16 stitch: {wall:.1f} s wall, peak device memory {peak:.2f}"
        f" GiB; contigs {st['n_contigs']} (canonical), total "
        f"{st['total_bp']} bp = {share:.4f} x genome, longest "
        f"{st['longest']}, N50 {st['n50']}; launches {json.dumps(got)}")
    if share < 0.95:
        raise SystemExit(f"stitch: total {share:.4f} x the genome")
    shutil.rmtree(out)

    # the 200 kb checks: kernel path vs plain path, byte-identical trees
    checks_200kb(torch, args, dev, work)


def checks_200kb(torch, args, dev, work) -> None:
    """``run -kmer 61``, ``preprocess`` (device correction),
    ``reassembler``, ``merger`` and ``stitch`` with the kernels and with
    their plain versions on the 200 kb genome; ``stitch`` also once over
    phase 8's ``reduce`` directory (its ``Stitch_kmer/Count_31_sorted``)."""
    from reflexiv_tpu_torch import count, metrics
    from reflexiv_tpu_torch.assembler import (assemble_from_counts,
                                              assemble_reads)
    from reflexiv_tpu_torch.merger import merge_contigs_cmd
    from reflexiv_tpu_torch.params import Params
    from reflexiv_tpu_torch.preprocess import preprocess
    from reflexiv_tpu_torch.reassemble import reassemble
    from reflexiv_tpu_torch.stitch import stitch

    g_small, small = simulate(np.random.default_rng(args.seed + 1), CHECK_BP)
    sfq = os.path.join(work, "small.fq")
    slens = np.full(small.shape[0], READ_LEN, np.int32)
    params = Params(k=61, min_kmer_coverage=3)
    metrics.reset()
    with_kernels = assemble_reads(small, slens, params, seed=0, device=dev)
    keys, counts = count.count_kmers(small, slens, k=61, min_cov=3,
                                     device=dev, plain=True)
    plain_path = assemble_from_counts(keys, counts, params, seed=0,
                                      device=dev)
    if not with_kernels or with_kernels != plain_path:
        raise SystemExit("run -kmer 61 at 200 kb: kernel path != plain path")
    say(f"checks 200 kb run -kmer 61: kernel path == plain path, "
        f"{len(with_kernels)} contigs")
    sfa = os.path.join(work, "small_contigs.fa")
    write_fasta(sfa, [s for _h, s in with_kernels])
    m1, m2, _f, _i = simulate_overlapping_pairs(
        np.random.default_rng(args.seed + 7), g_small)
    spairs = write_pairs(work, "small_pre", m1, m2)
    sfrags = os.path.join(work, "small_frags.fa")
    write_fasta(sfrags, sample_fragments(np.random.default_rng(args.seed + 8),
                                         g_small, N_REASSEMBLY_FRAGS_CHECK))
    checks = (
        ("preprocess", preprocess, dict(input_fastq=spairs)),
        ("reassembler", reassemble, dict(k=31, min_kmer_coverage=3,
                                         input_fastq=sfq,
                                         input_contig=sfrags)),
        ("stitch", stitch, dict(input_fastq=sfq, input_contig=sfa)),
    )
    for label, entry, kw in checks:
        dirs, walls = [], []
        for name, plain in (("kernels", False), ("plain", True)):
            d = os.path.join(work, f"c200_{label}_{name}")
            metrics.reset()
            if label == "preprocess":    # the device correction
                os.environ["REFLEXIV_DEVICE_STAGES"] = "1"
            try:
                t0 = time.perf_counter()
                entry(Params(output_path=d, **kw), device=dev, plain=plain)
                walls.append(time.perf_counter() - t0)
            finally:
                os.environ.pop("REFLEXIV_DEVICE_STAGES", None)
            dirs.append(d)
        same_trees(label, *dirs)
        say(f"checks 200 kb {label}: kernel path == plain path, "
            f"{len(tree_files(dirs[0]))} files byte-identical; "
            f"{walls[0]:.1f} s vs {walls[1]:.1f} s")
    # merger has no kernel: it runs on each path's reassembler and stitch
    # contigs, and the two trees must agree too
    for name in ("kernels", "plain"):
        union = os.path.join(work, f"c200_union_{name}.fa")
        write_fasta(union, [s for rel in (
            f"c200_reassembler_{name}/Assemble_31/part-00000",
            f"c200_stitch_{name}/Assembly_stitched_61/part-00000")
            for _h, s in contig_seqs(os.path.join(work, rel))])
        merge_contigs_cmd(Params(input_fasta=union, output_path=os.path.join(
            work, f"c200_merger_{name}")))
    same_trees("merger", *(os.path.join(work, f"c200_merger_{n}")
                           for n in ("kernels", "plain")))
    say("checks 200 kb merger on each path's contigs: byte-identical")
    # stitch over phase 8's reduce directory reuses its k = 31 table
    metrics.reset()
    stitch(Params(input_fastq=sfq, input_contig=sfa,
                  output_path=os.path.join(work, "kernels")), device=dev)
    rows31 = metrics.current().counts.get("stitch/table_rows_k31", 0)
    if rows31 < 1:
        raise SystemExit("stitch over a reduce directory did not reuse "
                         "Stitch_kmer/Count_31_sorted")
    say(f"checks 200 kb stitch over phase 8's reduce directory: "
        f"Stitch_kmer/Count_31_sorted reused ({rows31} rows), "
        f"{metrics.current().counts['stitch/contigs_k61']} contigs")


def same_trees(label: str, a: str, b: str) -> None:
    files = tree_files(a)
    if not files or files != tree_files(b):
        raise SystemExit(f"{label}: kernel and plain paths wrote other files")
    differ = [f for f in files if not filecmp.cmp(
        os.path.join(a, f), os.path.join(b, f), shallow=False)]
    if differ:
        raise SystemExit(f"{label} at {CHECK_BP} bp: files differ: {differ}")

# ---------------------------------------------------------------------------
# phase 17: counting past the single-pass bound, from disk; 17b: forced
# spill and streaming at 4.64 Mbp; the 200 kb budget checks
# ---------------------------------------------------------------------------

BIG_GENOME_BP = 100_286_401   # C. elegans WBcel235
BIG_READ_LEN = 150
BIG_SLICE = 1 << 20           # reads made and written at a time
BIG_BUDGET_MB = 256
SPILL_BUDGET_MB, SPILL_ROWS = 16, 8_000_000   # phase 17b

TABLE_CHECK = r"""
import json, sys, time
import torch
from reflexiv_tpu_torch import metrics
from reflexiv_tpu_torch.count import (STREAM_WINDOW_LIMIT, count_kmers_auto,
                                      count_kmers_from_files)
from reflexiv_tpu_torch.io import ingest_budget_bytes, load_reads
from reflexiv_tpu_torch.kernels import extract, radix_sort

dev = torch.device("cuda")
met = metrics.reset()
t0 = time.perf_counter()
a = count_kmers_from_files(sys.argv[1], k=31, min_cov=1,
                           budget_bytes=ingest_budget_bytes(), device=dev)
torch.cuda.synchronize()
t1 = time.perf_counter()
streamed = {"extract": extract.LAUNCHES, "sort": radix_sort.LAUNCHES}
timers, counters = dict(met.timers), dict(met.counts)
mat, lens = load_reads(sys.argv[1])
t2 = time.perf_counter()
b = count_kmers_auto(mat, lens, k=31, min_cov=1, device=dev)
torch.cuda.synchronize()
t3 = time.perf_counter()
result = {
    "equal": all(x.shape == y.shape and bool(torch.equal(x, y))
                 for x, y in zip(a, b)),
    "rows": a[1].numel(), "count_total": int(a[1].sum()),
    "windows": int(mat.shape[0]) * (int(mat.shape[1]) - 30),
    "streamed_launches": streamed,
    "launches": {"extract": extract.LAUNCHES, "sort": radix_sort.LAUNCHES},
    "files_s": t1 - t0, "load_s": t2 - t1, "auto_s": t3 - t2,
    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    "timers": timers, "counters": counters}
del a, b
torch.cuda.empty_cache()


def max_err(x, y):
    if x.shape != y.shape:
        return -1
    step = 1 << 27
    return max((int((x[i:i + step] - y[i:i + step]).abs().max())
                for i in range(0, x.shape[0], step)), default=0)


# one counting pass of the loaded matrix (count_kmers_auto's first chunk,
# 150 bp reads), each kernel against its plain version on the same tensors;
# these launches are not the main path's
rows = min(STREAM_WINDOW_LIMIT, radix_sort.MAX_N) // (mat.shape[1] - 30)
bases = torch.from_numpy(mat[:rows]).to(dev)
blens = torch.from_numpy(lens[:rows]).to(dev, torch.int32)
del mat, lens
want = extract.extract_canonical_keys_torch(bases, blens, k=31)
keys = extract.extract_canonical_keys(bases, blens, k=31)
result["pass_reads"], result["pass_width"] = bases.shape
result["pass_windows"] = keys.numel()
result["extract_err"] = max_err(keys, want)
del want, bases, blens
want = radix_sort.sort_keys_torch(keys)
got = radix_sort.sort_keys(keys, bits=62)
result["sort_err"] = max_err(got, want)
print(json.dumps(result))
"""


def write_big_fastq(rng, path: str):
    """Phase 17's input: a random genome of BIG_GENOME_BP and 150 bp reads
    at 30x from both strands with ERR substitutions, made and written as
    FASTQ BIG_SLICE reads at a time (the host never holds them all).
    Returns the genome and the read count."""
    genome = rng.integers(0, 4, BIG_GENOME_BP, dtype=np.uint8)
    n = DEPTH * BIG_GENOME_BP // BIG_READ_LEN
    windows = np.lib.stride_tricks.sliding_window_view(genome, BIG_READ_LEN)
    with open(path, "wb") as fh:
        for lo in range(0, n, BIG_SLICE):
            m = min(BIG_SLICE, n - lo)
            reads = windows[rng.integers(0, len(windows), m)]
            # ERR of the bases, drawn as positions: a float per base would
            # cost more than the rest of the slice
            n_err = rng.binomial(reads.size, ERR)
            reads.reshape(-1)[rng.integers(0, reads.size, n_err)] = \
                rng.integers(0, 4, n_err, dtype=np.uint8)
            flip = rng.random(m) < 0.5
            reads[flip] = 3 - reads[flip, ::-1]
            fastq_records(reads).tofile(fh)
    return genome, n


# A process's peak RSS starts at its parent's RSS when it forks (Linux
# keeps the high-water mark across exec), and this script's own RSS is
# many GiB by phase 17: so a small launcher starts each leg and reads the
# leg's rusage from os.wait4.
RSS_LAUNCHER = r"""
import json, os, subprocess, sys
proc = subprocess.Popen(sys.argv[2:])
_pid, status, usage = os.wait4(proc.pid, 0)
proc.returncode = os.waitstatus_to_exitcode(status)
with open(sys.argv[1], "w") as fh:
    json.dump({"rc": proc.returncode, "maxrss_kib": usage.ru_maxrss}, fh)
sys.exit(proc.returncode)
"""


def child(argv, log_path: str, budget_mb: int = 0):
    """Run ``argv`` as a child process of :data:`RSS_LAUNCHER` (the budget
    set, or unset), its output to ``log_path``. Returns (exit code, wall
    s, peak RSS GiB from ``os.wait4``'s rusage)."""
    env = dict(os.environ)
    env.pop("REFLEXIV_INGEST_BUDGET_MB", None)
    if budget_mb:
        env["REFLEXIV_INGEST_BUDGET_MB"] = str(budget_mb)
    usage = log_path + ".rusage.json"
    t0 = time.perf_counter()
    with open(log_path, "w") as fh:
        rc = subprocess.run([sys.executable, "-c", RSS_LAUNCHER, usage]
                            + argv, cwd=REPO, env=env, stdout=fh,
                            stderr=subprocess.STDOUT).returncode
    wall = time.perf_counter() - t0
    with open(usage) as fh:
        got = json.load(fh)
    return rc, wall, got["maxrss_kib"] / 2**20


def last_line(path: str) -> str:
    with open(path) as fh:
        lines = fh.read().splitlines()
    return lines[-1] if lines else ""


def phase_17(torch, args, work, launches, rows) -> None:
    """Phase 17: 2,406,873,600 windows at k = 31 from a FASTQ file, in
    three child processes: (a) the table from disk under a 256 MB budget
    against ``count_kmers_auto`` on the loaded matrix, then the extraction
    kernel and the sort against their plain versions on one counting pass
    of that matrix (their max errors go into ``rows``); (b) ``run`` under
    the budget; (c) ``run`` on the whole matrix. ``launches`` sums the
    legs' main-path launches."""
    from reflexiv_tpu_torch.contigs import assembly_stats

    torch.cuda.empty_cache()
    free = shutil.disk_usage(work).free
    if free < 7 << 30:
        raise SystemExit(f"phase 17 needs about 7 GB of free disk in {work},"
                         f" {free / 2**30:.1f} GiB free")
    fq = os.path.join(work, "big.fq")
    t0 = time.perf_counter()
    _genome, n = write_big_fastq(np.random.default_rng(args.seed + 9), fq)
    windows = n * (BIG_READ_LEN - 30)
    say(f"phase 17 input: {BIG_GENOME_BP} bp genome, {n} reads x "
        f"{BIG_READ_LEN} bp (30x, {ERR} substitutions), {windows} windows "
        f"at k = 31 ({windows / 2**31:.4f} x 2^31), "
        f"{os.path.getsize(fq)} bytes of FASTQ, made in "
        f"{time.perf_counter() - t0:.1f} s")

    def tally(got, leg):
        if min(got.get("extract", 0), got.get("sort", 0)) < 1:
            raise SystemExit(f"phase 17 ({leg}) skipped a kernel: {got}")
        for name, c in got.items():
            launches[name] = launches.get(name, 0) + c

    log = os.path.join(work, "p17a.log")
    rc, wall, rss = child([sys.executable, "-c", TABLE_CHECK, fq], log,
                          BIG_BUDGET_MB)
    if rc != 0:
        raise SystemExit(f"phase 17 (a) exited {rc}: {last_line(log)}")
    a = json.loads(last_line(log))
    if not a["equal"] or a["count_total"] != a["windows"]:
        raise SystemExit(f"phase 17 (a): from files != count_kmers_auto, "
                         f"or {a['count_total']} counted of {a['windows']} "
                         "windows")
    if min(a["streamed_launches"].values()) < 1:
        raise SystemExit(f"phase 17 (a) streamed without a kernel: {a}")
    if a["extract_err"] != 0 or a["sort_err"] != 0:
        raise SystemExit(f"phase 17 (a): kernel != plain on one pass of "
                         f"{a['pass_reads']} x {a['pass_width']} bp reads: "
                         f"extract max error {a['extract_err']}, sort max "
                         f"error {a['sort_err']} (-1: shapes differ)")
    for key in ("extract", "sort"):
        err, ms, pms = rows[key]
        rows[key] = (max(err, a[f"{key}_err"]), ms, pms)
    tally(a["launches"], "a")
    say(f"phase 17 (a) table: count_kmers_from_files at "
        f"REFLEXIV_INGEST_BUDGET_MB={BIG_BUDGET_MB} == count_kmers_auto on "
        f"the loaded matrix, {a['rows']} unique 31-mers (min_cov 1), every "
        f"window counted; from files {a['files_s']:.1f} s (launches "
        f"{json.dumps(a['streamed_launches'])}, "
        f"{a['counters'].get('count.chunks')} chunks, "
        f"{a['counters'].get('count.spills', 0)} spills, "
        f"count.input_stall_s {a['timers'].get('count.input_stall_s', 0):.1f}"
        f", count.device_loop_s "
        f"{a['timers'].get('count.device_loop_s', 0):.1f}, count.ingest_s "
        f"{a['timers'].get('count.ingest_s', 0):.1f}), load {a['load_s']:.1f}"
        f" s, count_kmers_auto {a['auto_s']:.1f} s; peak device memory "
        f"{a['peak_gib']:.2f} GiB; wall {wall:.1f} s, peak RSS {rss:.2f} GiB;"
        f" launches in all {json.dumps(a['launches'])}; kernel == plain on "
        f"one pass of {a['pass_reads']} reads x {a['pass_width']} bp "
        f"({a['pass_windows']} windows): extract max error "
        f"{a['extract_err']}, sort max error {a['sort_err']}")

    legs = {}
    for leg, budget in (("b", BIG_BUDGET_MB), ("c", 0)):
        out = os.path.join(work, f"p17{leg}")
        log = out + ".log"
        rc, wall, rss = child(
            [sys.executable, "-m", "reflexiv_tpu_torch.cli", "run", "-fastq",
             fq, "-kmer", "31", "-cover", "3", "-outfile", out, "-device",
             "cuda"], log, budget)
        if rc != 0:
            raise SystemExit(f"phase 17 ({leg}) run exited {rc}: "
                             f"{last_line(log)}")
        with open(os.path.join(out, "metrics.json")) as fh:
            met = json.load(fh)
        c, t = met["counters"], met["stages_s"]
        got = {name.split("/", 1)[1]: v for name, v in c.items()
               if name.startswith("launches/")}
        tally(got, leg)
        contigs = contig_seqs(os.path.join(out, "part-00000"))
        st = assembly_stats(contigs)
        legs[leg] = (rss, os.path.join(out, "part-00000"), st)
        say(f"phase 17 ({leg}) run -kmer 31 -cover 3"
            f"{f' at REFLEXIV_INGEST_BUDGET_MB={budget}' if budget else ', whole matrix'}"
            f": wall {wall:.1f} s, peak RSS {rss:.2f} GiB, peak device memory "
            f"{c.get('device/peak_bytes', 0) / 2**30:.2f} GiB; chunks "
            f"{c.get('count.chunks')}, unique 31-mers before the band "
            f"{c.get('count.table_rows_k31')}, after "
            f"{c.get('run/solid_kmers')}, spilled "
            f"{'yes' if c.get('count.spills') else 'no'}; count.input_stall_s"
            f" {t.get('count.input_stall_s', 0):.1f}, count.device_loop_s "
            f"{t.get('count.device_loop_s', 0):.1f}, count.ingest_s "
            f"{t.get('count.ingest_s', 0):.1f}; contigs {st['n_contigs']} "
            f"(canonical), total {st['total_bp']} bp = "
            f"{st['total_bp'] / BIG_GENOME_BP:.4f} x genome, N50 {st['n50']};"
            f" launches {json.dumps(got)}; stages_s {json.dumps(t)}")
    if not filecmp.cmp(legs["b"][1], legs["c"][1], shallow=False):
        raise SystemExit("phase 17: run under the budget and on the whole "
                         "matrix wrote other contigs")
    share = legs["b"][2]["total_bp"] / BIG_GENOME_BP
    if not 0.95 <= share <= 1.05:
        raise SystemExit(f"phase 17: contig total {share:.4f} x the genome, "
                         "outside [0.95, 1.05]")
    if not legs["b"][0] < legs["c"][0]:
        raise SystemExit(f"phase 17: peak RSS under the budget "
                         f"{legs['b'][0]:.2f} GiB is not below the whole "
                         f"matrix's {legs['c'][0]:.2f} GiB")
    say(f"phase 17: (b) and (c) part-00000 byte-identical; peak RSS "
        f"{legs['b'][0]:.2f} GiB under the budget vs {legs['c'][0]:.2f} GiB")
    for leg in ("p17b", "p17c"):
        shutil.rmtree(os.path.join(work, leg))
    os.remove(fq)


def same_table(torch, label, got, want) -> None:
    if not all(x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(got, want)):
        raise SystemExit(f"{label}: table differs from the one-pass table")


def phase_17b(torch, dev, work, fq, launches) -> None:
    """Phase 17b on phase 4's FASTQ: the spill path (16 MB chunks, an
    8M-row device table), ``count_kmers_auto -partition 8`` and the
    one-pass ladder over the default klist, each against the one-pass
    ``count_kmers`` table. The streaming calls' launches count; the
    one-pass references' do not."""
    from reflexiv_tpu_torch import count, metrics
    from reflexiv_tpu_torch.io import ingest_budget_bytes, load_reads
    from reflexiv_tpu_torch.kernels import extract, radix_sort
    from reflexiv_tpu_torch.params import DEFAULT_KLIST

    mat, lens = load_reads(fq)
    bases = torch.from_numpy(mat).to(dev)
    blens = torch.from_numpy(lens).to(dev)
    zero_launches(extract, radix_sort)
    os.environ["REFLEXIV_INGEST_BUDGET_MB"] = str(SPILL_BUDGET_MB)
    os.environ["REFLEXIV_DEVICE_TABLE_ROWS"] = str(SPILL_ROWS)
    try:
        m = metrics.reset()
        t0 = time.perf_counter()
        spill = count.count_kmers_from_files(
            fq, k=31, min_cov=1, budget_bytes=ingest_budget_bytes(),
            device=dev)
        spill_s = time.perf_counter() - t0
        spill_counts = dict(m.counts)
    finally:
        os.environ.pop("REFLEXIV_DEVICE_TABLE_ROWS")
    try:
        m = metrics.reset()
        part = count.count_kmers_auto(bases, blens, k=31, min_cov=3,
                                      partitions=8, device=dev)
        part_chunks = m.counts.get("count.chunks")
        t0 = time.perf_counter()
        multi = count.count_kmers_from_files_multi(
            fq, DEFAULT_KLIST, min_cov=1, budget_bytes=ingest_budget_bytes(),
            device=dev)
        torch.cuda.synchronize()
        multi_s = time.perf_counter() - t0
    finally:
        os.environ.pop("REFLEXIV_INGEST_BUDGET_MB")
    got = path_launches()
    if spill_counts.get("count.spills", 0) < 3:
        raise SystemExit(f"phase 17b: {spill_counts} spilled fewer than 3 "
                         "segments")
    if min(got.get(name, 0) for name in ["extract", "sort"] + [
            f"{p}{W}" for W in (2, 3, 4)
            for p in ("extract_rows", "sort_rows")]) < 1:
        raise SystemExit(f"phase 17b skipped a kernel: {got}")
    for name, c in got.items():
        launches[name] = launches.get(name, 0) + c
    ref = count.count_kmers(bases, blens, k=31, min_cov=1, device=dev)
    same_table(torch, "phase 17b spill", spill, ref)
    band = ref[1] >= 3
    same_table(torch, "phase 17b -partition 8", part,
               (ref[0][band], ref[1][band]))
    del ref, band, spill, part
    for k in DEFAULT_KLIST:
        same_table(torch, f"phase 17b ladder k={k}", multi.pop(k),
                   count.count_kmers(bases, blens, k=k, min_cov=1,
                                     device=dev))
    say(f"phase 17b at {GENOME_BP} bp: from files at "
        f"REFLEXIV_INGEST_BUDGET_MB={SPILL_BUDGET_MB} with "
        f"REFLEXIV_DEVICE_TABLE_ROWS={SPILL_ROWS}: "
        f"{spill_counts.get('count.chunks')} chunks, "
        f"{spill_counts.get('count.spills')} segments spilled, "
        f"{spill_counts.get('count.table_rows_k31')} rows, {spill_s:.1f} s; "
        f"count_kmers_auto -partition 8: {part_chunks} chunks; the one-pass "
        f"ladder over {list(DEFAULT_KLIST)} in {multi_s:.1f} s; every table "
        f"equal to one-pass count_kmers; launches {json.dumps(got)}")
    del bases, blens
    torch.cuda.empty_cache()


def checks_200kb_streaming(torch, args, dev, work) -> None:
    """At 200 kb: ``reduce`` and ``meta`` under a 1 MB budget through the
    kernels against phase 8's and phase 10's whole-matrix plain-path files,
    and end extension with its window index in several chunks against
    one chunk."""
    from reflexiv_tpu_torch import mapping, metrics
    from reflexiv_tpu_torch.dynamic import dynamic_reduction
    from reflexiv_tpu_torch.meta import dynamic_assembly
    from reflexiv_tpu_torch.params import Params

    sfq = os.path.join(work, "small.fq")
    os.environ["REFLEXIV_INGEST_BUDGET_MB"] = "1"
    try:
        rdir, mdir = (os.path.join(work, f"budget_{n}")
                      for n in ("reduce", "meta"))
        m = metrics.reset()
        dynamic_reduction(Params(min_kmer_coverage=3, input_fastq=sfq,
                                 output_path=rdir), device=dev)
        chunks = m.counts.get("count.chunks")
        metrics.reset()
        dynamic_assembly(Params(min_kmer_coverage=3, input_fastq=sfq,
                                output_path=mdir), device=dev)
    finally:
        os.environ.pop("REFLEXIV_INGEST_BUDGET_MB")
    same_trees("reduce under the budget", rdir, os.path.join(work, "plain"))
    ref = os.path.join(work, "meta_plain200kb")
    names = ["Assembly/part-00000"] + [
        os.path.join("steps/00sorted", f)
        for f in tree_files(os.path.join(ref, "steps", "00sorted"))]
    differ = [f for f in names if not filecmp.cmp(
        os.path.join(mdir, f), os.path.join(ref, f), shallow=False)]
    if differ or len(names) < 2:
        raise SystemExit(f"meta under the budget differs: {differ}")
    say(f"checks 200 kb under REFLEXIV_INGEST_BUDGET_MB=1 ({chunks} chunks "
        f"in reduce): reduce tree and meta {len(names)} files "
        "(Assembly/part-00000, steps/00sorted) byte-identical to the "
        "whole-matrix plain path")

    from reflexiv_tpu_torch.io import load_reads

    mat, lens = load_reads(sfq)
    bases, blens = (torch.from_numpy(x).to(dev) for x in (mat, lens))
    contigs = [s[300:-300] for _h, s in contig_seqs(
        os.path.join(ref, "Assembly", "part-00000")) if len(s) > 1000]
    one = mapping.end_extend_arrays(contigs, bases, blens)
    whole = mapping.INDEX_WINDOWS
    mapping.INDEX_WINDOWS = bases.shape[0] * (bases.shape[1] - 30) // 5
    try:
        n_chunks = len(mapping.WindowIndex(bases, blens, 31).chunks)
        chunked = mapping.end_extend_arrays(contigs, bases, blens)
    finally:
        mapping.INDEX_WINDOWS = whole
    grown = sum(len(a) - len(b) for a, b in zip(one, contigs))
    if chunked != one or n_chunks < 2 or grown < 1:
        raise SystemExit(f"end extension: {n_chunks} index chunks differ "
                         f"from one, or nothing grew ({grown} bases)")
    say(f"checks 200 kb end extension: window index in {n_chunks} chunks == "
        f"one chunk on {len(contigs)} trimmed contigs, {grown} bases grown")


# ---------------------------------------------------------------------------
# phase 18: run on a device mesh
# ---------------------------------------------------------------------------

MESH_SHARDS = 4   # virtual shards of cuda:0


def phase_18(torch, args, work, fq, rounds4, launches, rows) -> None:
    """18a: phase 4's reads through ``cli.cmd_run`` on one card (warm, for
    the comparison) and then on a mesh of :data:`MESH_SHARDS` virtual
    shards of ``cuda:0``, each with the launch counts set to 0 just before
    it; the mesh's canonical contig set must equal phase 4's, every shard
    must extract and sort, and its rounds must lie within 3 of phase 4's.
    Then, on the same reads and mesh, each shard's counting pass holds the
    extraction kernel and the sort to their plain versions (their max
    errors go into ``rows``), and ``count_kmers_sharded`` at min_cov 1
    through the kernels equals it through the plain versions, shard for
    shard. 18b: the 200 kb genome on that mesh, kernel path against plain
    path. 18c: :func:`mesh_walls` where there are several cards."""
    from reflexiv_tpu_torch import cli, metrics, parallel
    from reflexiv_tpu_torch.contigs import assembly_stats, canonical_set
    from reflexiv_tpu_torch.kernels import extract, radix_sort
    from reflexiv_tpu_torch.params import Params

    want = canonical_set(contig_seqs(os.path.join(work, "run31.fa")))
    dev = torch.device("cuda", 0)
    mesh = parallel.make_mesh([dev] * MESH_SHARDS)
    out = os.path.join(work, "asm_mesh")
    params = Params(k=31, min_kmer_coverage=3, input_fastq=fq,
                    output_path=out)

    def drive(mesh):
        """One ``cmd_run``: (wall, peak bytes, launches, metrics,
        contigs)."""
        m = metrics.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches(extract, radix_sort)
        t0 = time.perf_counter()
        cli.cmd_run(params, args.seed, dev, mesh=mesh)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = {name: n for name, n in path_launches().items() if n}
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        contigs = contig_seqs(os.path.join(out, "part-00000"))
        shutil.rmtree(out)
        return (wall, torch.cuda.max_memory_allocated(dev), got, m,
                contigs)

    one_wall, one_peak, _got, one, _contigs = drive(None)
    wall, peak, got, m, contigs = drive(mesh)
    counters, stages = dict(m.counts), m.snapshot()["stages_s"]
    rounds = counters["sharded/extension_rounds"]
    stats = assembly_stats(contigs)
    if canonical_set(contigs) != want:
        raise SystemExit("phase 18a: the mesh's canonical contigs differ "
                         "from phase 4's")
    if got.get("extract", 0) < MESH_SHARDS or got.get("sort", 0) < \
            MESH_SHARDS:
        raise SystemExit(f"phase 18a: a shard skipped a kernel: {got}")
    if abs(rounds - rounds4) > 3:
        raise SystemExit(f"phase 18a: {rounds} rounds, phase 4 {rounds4}")

    # each shard's counting pass, kernel against plain, then the tables
    mat, lens = cli._load_read_matrix(params)
    errs = {"extract": 0, "sort": 0}
    passes = parallel.shard_passes(mat, 31, mesh)
    for lo, hi in (r for ranges in passes for r in ranges if r[1] > r[0]):
        b = torch.from_numpy(mat[lo:hi]).to(dev, torch.uint8)
        ln = torch.from_numpy(lens[lo:hi]).to(dev, torch.int32)
        keys = extract.extract_canonical_keys(b, ln, k=31)
        errs["extract"] = max(errs["extract"], exact_err(
            "phase 18a extract", keys,
            extract.extract_canonical_keys_torch(b, ln, k=31)))
        errs["sort"] = max(errs["sort"], exact_err(
            "phase 18a sort", radix_sort.sort_keys(keys, bits=62),
            radix_sort.sort_keys_torch(keys)))
        del b, ln, keys
    for key, err in errs.items():
        e, ms, pms = rows[key]
        rows[key] = (max(e, err), ms, pms)
    tables = [parallel.count_kmers_sharded(mat, lens, k=31, min_cov=1,
                                           mesh=mesh, plain=plain)
              for plain in (False, True)]
    table_err = 0
    for s, ((k1, c1), (k0, c0)) in enumerate(zip(*tables)):
        table_err = max(table_err,
                        exact_err(f"phase 18a shard {s} keys", k1, k0),
                        exact_err(f"phase 18a shard {s} counts", c1, c0))
    n_rows = sum(c.numel() for _, c in tables[0])
    del mat, lens, tables
    say(f"phase 18a run on {MESH_SHARDS} shards of cuda:0: {wall:.1f} s "
        f"wall (one card, warm, just before: {one_wall:.1f} s), peak "
        f"device memory {peak / 2**30:.2f} GiB (one card "
        f"{one_peak / 2**30:.2f}); contigs {stats['n_contigs']} "
        f"(canonical), total {stats['total_bp']} bp, N50 {stats['n50']}; "
        f"rounds {rounds} (phase 4 {rounds4}); launches "
        f"{json.dumps(got)}; stages_s {json.dumps(stages)} (one card "
        f"{json.dumps(one.snapshot()['stages_s'])}); counters "
        f"{json.dumps(counters)}; on {len(passes)} pass(es) a shard, "
        f"kernel vs plain max error: extract {errs['extract']}, sort "
        f"{errs['sort']}; count_kmers_sharded (min_cov 1, {n_rows} rows) "
        f"kernel vs plain max error {table_err}")
    torch.cuda.empty_cache()

    # 18b. kernel path vs plain path on the mesh, 200 kb
    _g, small = simulate(np.random.default_rng(args.seed + 1), CHECK_BP)
    slens = np.full(small.shape[0], READ_LEN, np.int32)
    small_params = Params(k=31, min_kmer_coverage=3)
    lists, walls = [], []
    for plain in (False, True):
        m = metrics.reset()
        t0 = time.perf_counter()
        lists.append(parallel.assemble_reads_sharded(
            small, slens, small_params, mesh=mesh, seed=0, plain=plain))
        walls.append(time.perf_counter() - t0)
    if not lists[0] or lists[0] != lists[1]:
        raise SystemExit(f"phase 18b: kernel path ({len(lists[0])} contigs)"
                         f" != plain path ({len(lists[1])}) on the mesh")
    say(f"phase 18b {CHECK_BP // 1000} kb on {MESH_SHARDS} shards: kernel "
        f"path == plain path, {len(lists[0])} contigs, "
        f"{m.counts['sharded/extension_rounds']} rounds; {walls[0]:.1f} s vs"
        f" {walls[1]:.1f} s")

    # 18c. the CLI's own mesh over every card
    cards = torch.cuda.device_count()
    if cards < 2:
        say(f"phase 18c did not run: {cards} card on this machine, and "
            "-device cuda meshes only over two or more")
        return
    mesh_walls(torch, work, fq, want)


def exact_err(name, got, want) -> int:
    """0, the max absolute difference of two integer tensors that must be
    equal; exits where they differ."""
    if got.shape != want.shape or not bool((got == want).all()):
        raise SystemExit(f"{name}: kernel != plain (shapes "
                         f"{tuple(got.shape)} / {tuple(want.shape)})")
    return 0


def mesh_walls(torch, work, fq, want=None) -> None:
    """18c: ``run`` on phase 4's FASTQ with ``-device cuda:0`` (one card)
    and ``-device cuda`` (a mesh over every card) in turns, one, mesh,
    mesh, one, each wall and stage split printed. Every run's canonical
    set must equal ``want`` (phase 4's; the first one-card run's when
    None), and every ``-device cuda`` run must have taken the mesh."""
    from reflexiv_tpu_torch import cli, metrics
    from reflexiv_tpu_torch.contigs import canonical_set

    cards = torch.cuda.device_count()
    out = os.path.join(work, "asm_cards")
    for i, device in enumerate(("cuda:0", "cuda", "cuda", "cuda:0")):
        t0 = time.perf_counter()
        rc = cli.main(["run", "-fastq", fq, "-kmer", "31", "-cover", "3",
                       "-outfile", out, "-device", device])
        for d in range(cards):
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        m = metrics.current()          # cli.main starts its own
        got = canonical_set(contig_seqs(os.path.join(out, "part-00000")))
        shutil.rmtree(out)
        want = got if want is None else want
        meshed = "sharded/extension_rounds" in m.counts
        if rc != 0 or got != want or meshed != (device == "cuda"):
            raise SystemExit(f"phase 18c: run -device {device} over {cards} "
                             f"cards exited {rc}, canonical set equal "
                             f"{got == want}, mesh {meshed}")
        rounds = m.counts.get("sharded/extension_rounds",
                              m.counts.get("run/extension_rounds"))
        say(f"phase 18c run {i + 1} -device {device} "
            f"({cards if meshed else 1} card(s)): {wall:.3f} s wall, "
            f"canonical set equal; rounds {rounds}; stages_s "
            f"{json.dumps(m.snapshot()['stages_s'])}")


# ---------------------------------------------------------------------------
# phase 19: meta on a device mesh
# ---------------------------------------------------------------------------

def mesh_meta(torch, dev, mesh, params, out):
    """One ``cli.cmd_meta`` on ``mesh`` into a fresh ``out``, the launch
    counts set to 0 just before it: (wall, peak bytes on any card of the
    mesh, launches, metrics, contigs). ``meta`` restarts the peak
    counters at each stage (``meta/<stage>.peak_bytes``), so the run's
    peak is the highest stage's or, if higher, what came after the
    last."""
    from reflexiv_tpu_torch import cli, metrics
    from reflexiv_tpu_torch.kernels import extract, radix_sort

    shutil.rmtree(out, ignore_errors=True)
    m = metrics.reset()
    cards = sorted(set(mesh.devices) | {dev}, key=str)
    torch.cuda.init()     # the allocator's stats need CUDA started
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    zero_launches(extract, radix_sort)
    t0 = time.perf_counter()
    cli.cmd_meta(params, 0, dev, mesh=mesh)
    for d in cards:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    got = {name: n for name, n in path_launches().items() if n}
    contigs = contig_seqs(os.path.join(out, "Assembly", "part-00000"))
    peak = max([m.counts.get("meta/peak_bytes", 0)]
               + [torch.cuda.max_memory_allocated(d) for d in cards])
    return wall, peak, got, m, contigs


def stage_peaks(m) -> str:
    """``meta``'s own peak of each stage, GiB, as one JSON object."""
    return json.dumps({
        name.split("/")[1].split(".")[0]: round(n / 2**30, 2)
        for name, n in m.counts.items()
        if name.startswith("meta/0") and name.endswith(".peak_bytes")})


def phase_19(torch, args, work, fq, genome, launches) -> None:
    """19a: phase 4's FASTQ through ``cli.cmd_meta`` on
    :data:`MESH_SHARDS` virtual shards of ``cuda:0`` (stage 00 counts on
    the mesh: a fresh -outfile, no ``Count_<k>_reduced``); its canonical
    total must reach 0.95 x the genome and every shard must launch
    extraction and the sort at every k. Then the shard tables at every k
    of the klist (W = 1-4, the shapes stage 00 gives the kernels),
    kernels against plain versions. 19b: ``meta`` and ``meta
    -accurate`` at 200 kb on that mesh, kernel path against plain path,
    identical ``Assembly/`` trees."""
    from reflexiv_tpu_torch import cli, meta, metrics, parallel
    from reflexiv_tpu_torch.bitpack import num_words
    from reflexiv_tpu_torch.contigs import assembly_stats, canonical_set
    from reflexiv_tpu_torch.params import DEFAULT_KLIST, Params

    dev = torch.device("cuda", 0)
    mesh = parallel.make_mesh([dev] * MESH_SHARDS)
    out = os.path.join(work, "meta_mesh")
    params = Params(min_kmer_coverage=3, input_fastq=fq, output_path=out)
    wall, peak, got, m, contigs = mesh_meta(torch, dev, mesh, params, out)
    for name, n in got.items():
        launches[name] = launches.get(name, 0) + n
    shutil.rmtree(out)
    stats = assembly_stats(contigs)
    share = stats["total_bp"] / GENOME_BP
    gstr = ACGT[genome].tobytes().decode()
    rc_str = ACGT[3 - genome[::-1]].tobytes().decode()
    exact = sum(len(c) for c in canonical_set(contigs)
                if c in gstr or c in rc_str)
    # at least once a shard for every k of each word count (stage 04
    # adds its own one-word launches)
    want = {}
    for k in DEFAULT_KLIST:
        W = num_words(k)
        for kind in ("extract", "sort"):
            name = kind if W == 1 else f"{kind}_rows{W}"
            want[name] = want.get(name, 0) + MESH_SHARDS
    short = {n: (got.get(n, 0), w) for n, w in want.items()
             if got.get(n, 0) < w}
    say(f"phase 19a meta on {MESH_SHARDS} shards of cuda:0: {wall:.1f} s "
        f"wall, peak device memory {peak / 2**30:.2f} GiB (each stage's "
        f"own, GiB: {stage_peaks(m)}); "
        f"{m.counts.get('meta/extension_rounds')} extension rounds; "
        f"contigs {stats['n_contigs']} (canonical), total "
        f"{stats['total_bp']} bp = {share:.4f} x genome, longest "
        f"{stats['longest']}, N50 {stats['n50']}, exact-match bp {exact}; "
        f"launches {json.dumps(got)}; stages_s "
        f"{json.dumps(m.snapshot()['stages_s'])}"
        f"; counters {json.dumps(m.counts)}")
    if share < 0.95:
        raise SystemExit(f"phase 19a: contig total {stats['total_bp']} bp "
                         f"is {share:.4f} x the genome, under 0.95")
    if short:
        raise SystemExit(f"phase 19a: a shard skipped a kernel at some k "
                         f"(launches, wanted): {short}")

    # every k's shard tables through the kernels against the plain
    # versions, at the per-shard shapes stage 00 gives them
    t0 = time.perf_counter()
    mat, lens = cli._load_read_matrix(params)
    table_rows, errs = {}, {}
    for k in DEFAULT_KLIST:
        tables = [parallel.count_kmers_sharded(mat, lens, k=k, min_cov=1,
                                               mesh=mesh, plain=plain)
                  for plain in (False, True)]
        errs[k] = max(
            max(exact_err(f"phase 19a k={k} shard {s} keys", k1, k0),
                exact_err(f"phase 19a k={k} shard {s} counts", c1, c0))
            for s, ((k1, c1), (k0, c0)) in enumerate(zip(*tables)))
        table_rows[k] = sum(c.numel() for _, c in tables[0])
        del tables
    del mat, lens
    torch.cuda.empty_cache()
    say(f"phase 19a shard tables (min_cov 1) kernel == plain at every k "
        f"on {MESH_SHARDS} shards, rows {json.dumps(table_rows)}, max abs "
        f"err {json.dumps(errs)}; {time.perf_counter() - t0:.1f} s")

    # 19b. kernel path vs plain path on the mesh, 200 kb
    _g, small = simulate(np.random.default_rng(args.seed + 1), CHECK_BP)
    sfq = os.path.join(work, "mesh_small.fq")
    write_fastq(sfq, small)
    for flags in ((), ("accurate",)):
        trees, walls = [], []
        for plain in (False, True):
            sout = os.path.join(work, f"mesh_meta_{int(plain)}")
            shutil.rmtree(sout, ignore_errors=True)
            sp = Params(min_kmer_coverage=3, input_fastq=sfq,
                        output_path=sout, sensitive=bool(flags))
            metrics.reset()
            t0 = time.perf_counter()
            meta.dynamic_assembly(sp, seed=0, device=dev, plain=plain,
                                  mesh=mesh)
            walls.append(time.perf_counter() - t0)
            trees.append(os.path.join(sout, "Assembly"))
        label = "phase 19b meta" + "".join(f" -{f}" for f in flags)
        same_trees(label, *trees)
        n = len(contig_seqs(os.path.join(trees[0], "part-00000")))
        say(f"{label} {CHECK_BP // 1000} kb on {MESH_SHARDS} shards: kernel "
            f"path == plain path (Assembly/ byte-identical), {n} contigs; "
            f"{walls[0]:.1f} s vs {walls[1]:.1f} s")
        for t in trees:
            shutil.rmtree(os.path.dirname(t))
    say(f"phase 19c did not run: it runs under --mesh-walls on a machine "
        f"with {MESH_SHARDS} or more cards (this one has "
        f"{torch.cuda.device_count()})")


# ---------------------------------------------------------------------------
# phase 20: the process mesh, one process per card or several on one
# ---------------------------------------------------------------------------

MESH_PROCS, MESH_LOCAL = 2, 2     # 20a: gloo processes x shards of cuda:0
MESH_CHILD_TIMEOUT = 240          # seconds a child, and each collective


def digests(outputs: dict) -> dict:
    """Each output's shards as short sha256 digests of their bytes, with
    shape and dtype: equal digests are equal tensors."""
    import hashlib

    return {name: [hashlib.sha256(t.contiguous().cpu().numpy().tobytes())
                   .hexdigest()[:32] + f"{tuple(t.shape)}{t.dtype}"
                   for t in ts]
            for name, ts in outputs.items()}


def slice_digests(torch, mat, lens, mesh) -> dict:
    """The digests of :func:`multiprocess_smoke.slice_outputs` at k = 31
    (``-cover 3``) and of the k = 61 tables, on ``mesh``."""
    from reflexiv_tpu_torch import parallel
    from reflexiv_tpu_torch.multiprocess_smoke import slice_outputs
    from reflexiv_tpu_torch.params import Params

    params = Params(k=31, min_kmer_coverage=3)
    got = digests(slice_outputs(
        mat, lens, k=31, min_cov=3, min_error=params.min_error_coverage,
        mesh=mesh))
    tables = parallel.count_kmers_sharded(mat, lens, k=61, min_cov=3,
                                          mesh=mesh)
    got.update(digests({"k61.keys": [t for t, _ in tables],
                        "k61.counts": [c for _, c in tables]}))
    return got


def mesh_child(torch, spec: dict) -> int:
    """One process of phase 20's process mesh (``spec``: rank, procs,
    backend, local devices, init URL, FASTQ). It counts its block of the
    FASTQ's reads at k = 31 (timed, with the time in the mesh's exchanges
    and gathers measured apart), then runs :func:`slice_digests` with the
    launch counts set to 0 just before, and prints one ``mesh-child`` JSON
    line: digests by global shard, launches, walls, peak device memory.
    Rank 0 then holds extraction and the sort to their plain versions on
    its counting passes."""
    from reflexiv_tpu_torch import parallel
    from reflexiv_tpu_torch.distributed import init_process_mesh
    from reflexiv_tpu_torch.io import load_reads
    from reflexiv_tpu_torch.kernels import extract, radix_sort
    from reflexiv_tpu_torch.multiprocess_smoke import block

    from reflexiv_tpu_torch.device import synchronize

    rank, procs = spec["rank"], spec["procs"]
    mesh = init_process_mesh(
        backend=spec["backend"], init_method=spec["init"],
        world_size=procs, rank=rank, local_devices=spec["devices"],
        timeout_s=MESH_CHILD_TIMEOUT)
    dev = mesh.devices[0]
    spent = [0.0]

    def timed(fn):
        def run(*a, **kw):
            synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            synchronize(dev)
            spent[0] += time.perf_counter() - t0
            return out
        return run

    mat, lens = load_reads(spec["fastq"])
    windows = int(np.maximum(lens.astype(np.int64) - 30, 0).sum())
    b, ln = (block(a, rank, procs, mesh.size) for a in (mat, lens))
    del mat, lens
    for name in ("exchange", "size_table", "allgather_ints"):
        setattr(mesh, name, timed(getattr(mesh, name)))
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches(extract, radix_sort)
    walls = []
    for _ in range(2):                # the first warms the allocator
        mesh.allgather_ints([0])      # every process starts together
        spent[0] = 0.0
        t0 = time.perf_counter()
        tables = parallel.count_kmers_sharded(b, ln, k=31, min_cov=3,
                                              mesh=mesh)
        synchronize(dev)
        walls.append((time.perf_counter() - t0, spent[0]))
        del tables
    zero_launches(extract, radix_sort)
    t0 = time.perf_counter()
    got = slice_digests(torch, b, ln, mesh)
    synchronize(dev)
    slice_s = time.perf_counter() - t0
    path = {name: n for name, n in path_launches().items() if n}
    peak = torch.cuda.max_memory_allocated(dev)
    errs = None
    passes = parallel.shard_passes(b, 31, mesh)    # a collective: every rank
    if rank == 0:
        errs = {"extract": 0, "sort": 0, "passes": 0}
        for ranges in passes:
            for lo, hi in (r for r in ranges if r[1] > r[0]):
                bb = torch.from_numpy(b[lo:hi]).to(dev)
                ll = torch.from_numpy(ln[lo:hi]).to(dev)
                keys = extract.extract_canonical_keys(bb, ll, k=31)
                exact_err("phase 20 extract", keys,
                          extract.extract_canonical_keys_torch(bb, ll, k=31))
                exact_err("phase 20 sort", radix_sort.sort_keys(keys, bits=62),
                          radix_sort.sort_keys_torch(keys))
                errs["passes"] += 1
    print("mesh-child " + json.dumps({
        "rank": rank, "first": mesh.first, "digests": got,
        "launches": path, "count_s": walls[-1][0],
        "count_exchange_s": walls[-1][1], "slice_s": slice_s,
        "peak": peak, "windows": windows, "transport": str(mesh.transport),
        "errs": errs}), flush=True)
    mesh.close()
    return 0


def run_mesh(torch, work, fq, procs, local, backend):
    """Phase 20's children over ``procs`` processes of ``local`` shards:
    their ``mesh-child`` records by rank, and the wall of the whole run."""
    from reflexiv_tpu_torch.multiprocess_smoke import run_children

    store = os.path.join(work, f"store_{backend}_{procs}")
    shutil.rmtree(store, ignore_errors=True)
    argvs = [[sys.executable, os.path.abspath(__file__), "--mesh-child",
              json.dumps({"rank": r, "procs": procs, "backend": backend,
                          "devices": [f"cuda:{0 if backend == 'gloo' else r}"]
                          * local,
                          "init": "file://" + store, "fastq": fq})]
             for r in range(procs)]
    t0 = time.perf_counter()
    try:
        outs = run_children(argvs, timeout_s=MESH_CHILD_TIMEOUT)
    except RuntimeError as e:
        raise SystemExit(f"phase 20 ({backend}, {procs} processes): {e}")
    wall = time.perf_counter() - t0
    recs = []
    for out in outs:
        line = [x for x in out.splitlines() if x.startswith("mesh-child ")]
        if not line:
            raise SystemExit(f"phase 20: a child printed no record:\n"
                             f"{out[-3000:]}")
        recs.append(json.loads(line[-1][len("mesh-child "):]))
    return recs, wall


def compare_mesh(label, recs, want) -> None:
    """Every output of the children, shard for shard by global index,
    equal to ``want`` (the single-controller mesh's digests)."""
    for name, shards in want.items():
        got = [None] * len(shards)
        for rec in recs:
            for i, d in enumerate(rec["digests"][name]):
                got[rec["first"] + i] = d
        if got != shards:
            bad = [g for g, (a, b) in enumerate(zip(got, shards)) if a != b]
            raise SystemExit(f"{label}: {name} differs from the "
                             f"single-controller mesh on shards {bad}")


def phase_20(torch, work, fq, launches, rows) -> None:
    """20a: :data:`MESH_PROCS` gloo processes of :data:`MESH_LOCAL` shards
    of ``cuda:0`` (:func:`mesh_child`) on phase 4's FASTQ, every output of
    :func:`slice_digests` equal shard for shard to one process over
    ``MESH_PROCS * MESH_LOCAL`` shards of ``cuda:0``; extraction and the
    sort launched in every child, and in child 0 equal to their plain
    versions on its counting passes. The children's launches join the
    kernels' line. 20b runs under ``--mesh-walls`` on several cards."""
    from reflexiv_tpu_torch import parallel
    from reflexiv_tpu_torch.io import load_reads

    t0 = time.perf_counter()
    recs, child_wall = run_mesh(torch, work, fq, MESH_PROCS, MESH_LOCAL,
                                "gloo")
    dev = torch.device("cuda", 0)
    mesh = parallel.make_mesh([dev] * (MESH_PROCS * MESH_LOCAL))
    mat, lens = load_reads(fq)
    walls = []
    for _ in range(2):
        t1 = time.perf_counter()
        tables = parallel.count_kmers_sharded(mat, lens, k=31, min_cov=3,
                                              mesh=mesh)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t1)
        del tables
    want = slice_digests(torch, mat, lens, mesh)
    del mat, lens
    torch.cuda.empty_cache()
    compare_mesh("phase 20a", recs, want)
    for rec in recs:
        short = [n for n in ("extract", "sort", "extract_rows2", "sort_rows2")
                 if not rec["launches"].get(n)]
        if short:
            raise SystemExit(f"phase 20a: child {rec['rank']} launched no "
                             f"{short}: {rec['launches']}")
        for name, n in rec["launches"].items():
            launches[name] = launches.get(name, 0) + n
    errs = recs[0]["errs"]
    if not errs["passes"]:
        raise SystemExit("phase 20a: child 0 held no counting pass to the "
                         "plain versions")
    for key in ("extract", "sort"):
        e, ms, pms = rows[key]
        rows[key] = (max(e, errs[key]), ms, pms)
    count_s = max(r["count_s"] for r in recs)
    say(f"phase 20a {MESH_PROCS} gloo processes x {MESH_LOCAL} shards of "
        f"cuda:0 on phase 4's reads: every output equal shard for shard to "
        f"one process over {mesh.size} shards ({len(want)} outputs: count "
        f"k=31 and k=61, fork records, a round, the census, a mixed-k "
        f"round); the children's run {child_wall:.1f} s; count k=31 "
        f"{count_s:.3f} s = {recs[0]['windows'] / count_s / 1e6:.1f} "
        f"Mkmers/s, of it exchange and gathers "
        f"{json.dumps([round(r['count_exchange_s'], 3) for r in recs])} s "
        f"(one process: {walls[-1]:.3f} s = "
        f"{recs[0]['windows'] / walls[-1] / 1e6:.1f} Mkmers/s); the rest "
        f"of the slice {json.dumps([round(r['slice_s'], 1) for r in recs])}"
        f" s; peak device memory a child "
        f"{json.dumps([round(r['peak'] / 2**30, 2) for r in recs])} GiB; "
        f"launches {json.dumps([r['launches'] for r in recs])}; gloo "
        f"transport: card tensors ({recs[0]['transport']}); child 0's "
        f"{errs['passes']} counting pass(es) kernel == plain; phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"phase 20b did not run: it runs under --mesh-walls on a machine "
        f"with two or more cards (this one has "
        f"{torch.cuda.device_count()})")


def multihost_rate(work, fq, procs) -> float:
    """``multihost_count`` over ``procs`` NCCL processes, one a card: the
    Mkmers/s it prints."""
    from reflexiv_tpu_torch.multiprocess_smoke import run_children

    store = os.path.join(work, f"store_count_{procs}")
    shutil.rmtree(store, ignore_errors=True)
    argv = [sys.executable, "-m", "reflexiv_tpu_torch.multihost_count",
            "--fastq", fq, "--k", "31", "--min-cov", "3", "--backend",
            "nccl", "--coordinator", "file://" + store, "--num-hosts",
            str(procs)]
    try:
        outs = run_children([argv + ["-device", f"cuda:{r}", "--host-id",
                                     str(r)] for r in range(procs)],
                            timeout_s=MESH_CHILD_TIMEOUT)
    except RuntimeError as e:
        raise SystemExit(f"phase 20b multihost_count x {procs}: {e}")
    m = re.search(r"counting: ([0-9.]+) Mkmers/s", outs[0])
    if not m:
        raise SystemExit(f"phase 20b: multihost_count printed no rate:\n"
                         f"{outs[0][-2000:]}")
    return float(m.group(1))


def process_mesh_cards(torch, work, fq) -> None:
    """20b: one NCCL process per card at 2 and 4 processes, every output
    of :func:`slice_digests` equal to one process over the same cards;
    then ``multihost_count``'s Mkmers/s at 1, 2 and 4 processes and one
    process's ``count_kmers_sharded`` over the same cards, in turns
    (processes, one, one, processes)."""
    from reflexiv_tpu_torch import parallel
    from reflexiv_tpu_torch.io import load_reads

    cards = torch.cuda.device_count()
    mat, lens = load_reads(fq)
    windows = int(np.maximum(lens.astype(np.int64) - 30, 0).sum())
    for procs in (p for p in (2, 4) if p <= cards):
        recs, wall = run_mesh(torch, work, fq, procs, 1, "nccl")
        mesh = parallel.make_mesh([torch.device("cuda", i)
                                   for i in range(procs)])
        compare_mesh(f"phase 20b ({procs} cards)", recs,
                     slice_digests(torch, mat, lens, mesh))
        say(f"phase 20b {procs} NCCL processes, one a card: every output "
            f"equal shard for shard to one process over the same cards; "
            f"children's run {wall:.1f} s; count k=31 "
            f"{max(r['count_s'] for r in recs):.3f} s, of it exchange and "
            f"gathers "
            f"{json.dumps([round(r['count_exchange_s'], 3) for r in recs])}"
            f" s; peak a child "
            f"{json.dumps([round(r['peak'] / 2**30, 2) for r in recs])} GiB")

    def one_process(procs) -> float:
        mesh = parallel.make_mesh([torch.device("cuda", i)
                                   for i in range(procs)])
        parallel.count_kmers_sharded(mat, lens, k=31, min_cov=3, mesh=mesh)
        t0 = time.perf_counter()
        for _ in range(3):
            parallel.count_kmers_sharded(mat, lens, k=31, min_cov=3,
                                         mesh=mesh)
            for d in mesh.devices:
                torch.cuda.synchronize(d)
        return windows / ((time.perf_counter() - t0) / 3) / 1e6

    for procs in (p for p in (1, 2, 4) if p <= cards):
        rates = [multihost_rate(work, fq, procs), one_process(procs),
                 one_process(procs), multihost_rate(work, fq, procs)]
        say(f"phase 20b count k=31 over {procs} card(s), Mkmers/s: "
            f"multihost_count ({procs} NCCL processes) {rates[0]:.1f} / "
            f"{rates[3]:.1f}; one process over the same cards "
            f"{rates[1]:.1f} / {rates[2]:.1f}")


def mesh_meta_cards(torch, work, fq) -> None:
    """19c: ``meta`` on phase 4's FASTQ on a mesh of the first
    :data:`MESH_SHARDS` cards (the CLI's own ``-device cuda`` mesh where
    there are exactly that many), byte-identical to the same on that many
    virtual shards of ``cuda:0``."""
    from reflexiv_tpu_torch import cli, parallel
    from reflexiv_tpu_torch.params import Params

    cards = torch.cuda.device_count()
    meshes = [parallel.make_mesh([torch.device("cuda", 0)] * MESH_SHARDS),
              cli._auto_mesh("cuda") if cards == MESH_SHARDS else
              parallel.make_mesh([torch.device("cuda", i)
                                  for i in range(MESH_SHARDS)])]
    files = []
    labels = (f"{MESH_SHARDS} shards of cuda:0", f"{MESH_SHARDS} cards")
    for i, mesh in enumerate(meshes):
        out = os.path.join(work, f"meta_cards_{i}")
        params = Params(min_kmer_coverage=3, input_fastq=fq, output_path=out)
        wall, peak, _got, m, contigs = mesh_meta(
            torch, torch.device("cuda", 0), mesh, params, out)
        with open(os.path.join(out, "Assembly", "part-00000"), "rb") as fh:
            files.append(fh.read())
        shutil.rmtree(out)
        say(f"phase 19c meta on {labels[i]}: {wall:.1f} s wall, peak "
            f"{peak / 2**30:.2f} GiB (stages {stage_peaks(m)}), "
            f"{len(contigs)} contigs, "
            f"{m.counts.get('meta/extension_rounds')} rounds; stages_s "
            f"{json.dumps(m.snapshot()['stages_s'])}")
    if files[0] != files[1]:
        raise SystemExit("phase 19c: meta on four cards differs from four "
                         "shards of one")
    say("phase 19c: Assembly/part-00000 byte-identical")


def mesh_walls_only(torch, args) -> int:
    """``--mesh-walls``: build, phase 4's input, then :func:`mesh_walls`
    and, with four or more cards, :func:`mesh_meta_cards` alone (a
    machine with several cards)."""
    from reflexiv_tpu_torch.kernels import build

    if torch.cuda.device_count() < 2:
        print("chip_smoke --mesh-walls needs two or more cards",
              file=sys.stderr)
        return 1
    say("nvidia-smi: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
        .replace("\n", "; "))
    build.lib()
    _genome, reads = simulate(np.random.default_rng(args.seed), GENOME_BP)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(REPO, "build"))
    try:
        fq = os.path.join(work, "reads.fq")
        write_fastq(fq, reads)
        del reads
        mesh_walls(torch, work, fq)
        if torch.cuda.device_count() >= MESH_SHARDS:
            mesh_meta_cards(torch, work, fq)
        process_mesh_cards(torch, work, fq)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
