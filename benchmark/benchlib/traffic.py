"""The one traffic generator: a genome and its reads from a seed, written
as one gzipped FASTQ.

A frozen copy of the repository's ``chip_smoke.simulate``,
``sample_reads`` and ``plant_repeats`` rules, with the sizes taken from a
configuration (genome length, read length, repeat families) and a traffic
mix (depth, substitution rate, strands). At 100 bp, 30x and 0.5% it draws
exactly ``chip_smoke.sample_reads``' reads from the same generator state:
the draws are made in the same order and sizes, only cut into row blocks
where the draw stream is the same either way, so no full-size temporary
of 8 bytes a base is made.
"""
from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
ROW_BLOCK = 1 << 19          # reads drawn, gathered or formatted at a time
GZIP_MEMBER_BYTES = 32 << 20  # FASTQ bytes per gzip member


def make_genome(rng, genome_bp: int, repeats, repeat_div: float) -> np.ndarray:
    """Random 2-bit genome with each repeat family ``(copies, bp)`` planted
    over it (:func:`plant_repeats`)."""
    genome = rng.integers(0, 4, genome_bp, dtype=np.uint8)
    if repeats:
        genome = plant_repeats(rng, genome, repeats, repeat_div)
    return genome


def plant_repeats(rng, genome: np.ndarray, repeats, repeat_div: float
                  ) -> np.ndarray:
    """A copy of ``genome`` with each family's copies written over it: each
    copy at a random place in a slot of its own, on a random strand, with
    ``repeat_div`` of its bases substituted."""
    out = genome.copy()
    n_copies = sum(n for n, _bp in repeats)
    slot = len(genome) // n_copies
    units = [rng.integers(0, 4, bp, dtype=np.uint8) for _n, bp in repeats]
    order = rng.permutation(n_copies)
    at = 0
    for f, (n, bp) in enumerate(repeats):
        if bp > slot:
            raise ValueError(f"a {bp} bp repeat does not fit a {slot} bp slot")
        for _ in range(n):
            copy = units[f].copy()
            sub = rng.random(bp) < repeat_div
            copy[sub] = (copy[sub] + rng.integers(1, 4, int(sub.sum()),
                                                  dtype=np.uint8)) % 4
            if rng.random() < 0.5:
                copy = 3 - copy[::-1]
            start = order[at] * slot + rng.integers(0, slot - bp + 1)
            out[start:start + bp] = copy
            at += 1
    return out


def n_reads(genome_bp: int, read_len: int, depth: int) -> int:
    return depth * genome_bp // read_len


def sample_reads(rng, genome: np.ndarray, *, read_len: int, depth: int,
                 error_rate: float, both_strands: bool = True) -> np.ndarray:
    """``(n, read_len)`` uint8 codes: reads at uniform random starts, each
    base redrawn (possibly to itself) with probability ``error_rate``, and
    with ``both_strands`` half of them reverse-complemented."""
    genome_bp = len(genome)
    n = n_reads(genome_bp, read_len, depth)
    starts = rng.integers(0, genome_bp - read_len + 1, n)
    cols = np.arange(read_len)
    reads = np.empty((n, read_len), np.uint8)
    err = np.empty((n, read_len), bool)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(n, lo + ROW_BLOCK)
        reads[lo:hi] = genome[starts[lo:hi, None] + cols]
    for lo in range(0, n, ROW_BLOCK):
        hi = min(n, lo + ROW_BLOCK)
        err[lo:hi] = rng.random((hi - lo, read_len)) < error_rate
    reads[err] = rng.integers(0, 4, int(err.sum()), dtype=np.uint8)
    del err
    if both_strands:
        flip = rng.random(n) < 0.5
        for lo in range(0, n, ROW_BLOCK):
            hi = min(n, lo + ROW_BLOCK)
            block = reads[lo:hi]
            f = flip[lo:hi]
            block[f] = 3 - block[f, ::-1]
    return reads


def fastq_records(reads: np.ndarray) -> np.ndarray:
    """FASTQ records of a read code matrix, one byte row per read: name
    ``@r``, constant quality ``I``."""
    n, L = reads.shape
    rec = np.empty((n, 2 * L + 7), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(n, lo + ROW_BLOCK)
        rec[lo:hi, 3:3 + L] = ACGT[reads[lo:hi]]
    rec[:, 3 + L:6 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + L:6 + 2 * L] = ord("I")
    rec[:, 6 + 2 * L] = ord("\n")
    return rec


def _gzip_member(data, level: int) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, 31)   # gzip wrapper, mtime 0
    return comp.compress(data) + comp.flush()


def write_fastq_gz(path: str, reads: np.ndarray, *, level: int,
                   threads: int = 8) -> int:
    """Write ``reads`` as gzipped FASTQ: members of about
    :data:`GZIP_MEMBER_BYTES` compressed on ``threads`` threads (zlib
    releases the GIL), concatenated as block-gzip writers lay them out.
    The bytes depend only on ``reads`` and ``level``. Returns the bytes
    written."""
    rec = fastq_records(reads)
    per = max(1, GZIP_MEMBER_BYTES // rec.shape[1])
    views = [memoryview(rec[lo:lo + per]).cast("B")
             for lo in range(0, rec.shape[0], per)]
    written = 0
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool, \
            open(path, "wb") as fh:
        for member in pool.map(lambda v: _gzip_member(v, level), views):
            fh.write(member)
            written += len(member)
    return written


def make_input(path: str, config: dict, traffic: dict, seed: int) -> dict:
    """The cell's one input file from ``seed``: genome, reads, gzipped
    FASTQ at ``path``. Returns its shape (reads, read length, bases,
    compressed bytes)."""
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, config["genome_bp"], config.get("repeats", []),
                         config.get("repeat_div", 0.0))
    reads = sample_reads(rng, genome, read_len=config["read_len"],
                         depth=traffic["depth"],
                         error_rate=traffic["error_rate"],
                         both_strands=traffic.get("both_strands", True))
    del genome
    gz_bytes = write_fastq_gz(path, reads, level=traffic.get("gzip_level", 1),
                              threads=min(8, os.cpu_count() or 1))
    R, L = reads.shape
    return {"reads": R, "read_len": L, "bases": R * L, "gz_bytes": gz_bytes}
