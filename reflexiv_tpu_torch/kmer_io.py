"""On-disk k-mer table format: the reference's ``Count_<k>`` CSV (``reflexiv_tpu.kmer_io``).

``KMERSTRING,count`` rows in ``Count_<k>/part-00000.csv[.gz]`` plus a
``_SUCCESS`` marker (``ReflexivDataFrameCounter.java:216-233``); the reader
also takes the reference's parenthesised Spark tuple dumps
(``ReflexivDSMain.java:3883-3907``).

The writers build each block of rows as one byte matrix on the device
(:func:`csv_bytes`) instead of formatting one string per row, and write the
same bytes as the JAX package's per-row f-strings. A gzip file is written
as one member per block of rows, at level 1, compressed in threads: it
decompresses to the JAX writer's bytes (the JAX stream, one member at
level 9, differs from run to run anyway by the time stamp in its header).
"""
from __future__ import annotations

import collections
import concurrent.futures
import gzip
import os
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

from .bitpack import (check_k, encode_ascii, num_words, pack_bases,
                      unpack_bases)
from .io import expand_paths, write_success_marker

ROWS_PER_BLOCK = 1 << 20   # rows formatted per byte matrix
GZIP_LEVEL = 1


def ascii_of_codes(codes: torch.Tensor) -> torch.Tensor:
    """2-bit codes -> ASCII ``ACGT`` in uint8 arithmetic on the codes'
    device: ``65 + 2c + 2(c >> 1) + 11 (c == 3)``."""
    c = codes.to(torch.uint8)
    return 65 + 2 * c + 2 * (c >> 1) + 11 * (c == 3).to(torch.uint8)


def _combo_index(ints):
    """Distinct combinations of one or two int32-range columns -> (host
    list of value tuples, per-row index of its combination)."""
    if len(ints) == 1:
        uniq, inv = torch.unique(ints[0], return_inverse=True)
        return [(v,) for v in uniq.tolist()], inv
    if len(ints) != 2:
        raise ValueError("csv_bytes takes at most two integer columns")
    a, b = ints
    uniq, inv = torch.unique((a << 32) | (b & 0xFFFFFFFF), return_inverse=True)
    combos = []
    for key in uniq.tolist():
        lo = key & 0xFFFFFFFF
        combos.append((key >> 32, lo - (1 << 32) if lo >= 1 << 31 else lo))
    return combos, inv


def csv_bytes(codes: torch.Tensor,
              columns: Sequence[Union[bytes, torch.Tensor]]) -> bytes:
    """Rows ``KMER<columns...>`` as bytes, formatted on the tensors'
    device: ``codes`` ``(M, k)`` 2-bit codes give the k-mer text; each
    column is a constant (bytes) or one integer per row (at most two
    integer columns, each in the int32 range), written in decimal.

    The text after the k-mer is formatted once per distinct combination of
    the integer columns (a few hundred on a k-mer table) and padded with 0
    bytes; each row is its k-mer and its tail in one ``(M, k + width)``
    byte matrix, and dropping the 0 bytes (no row text holds one) leaves
    the rows' text in order."""
    m, k = codes.shape
    if m == 0:
        return b""
    dev = codes.device
    ints = [c.to(device=dev, dtype=torch.int64) for c in columns
            if not isinstance(c, bytes)]
    if ints:
        combos, inv = _combo_index(ints)
    else:
        combos, inv = [()], torch.zeros(m, dtype=torch.int64, device=dev)
    tails = []
    for combo in combos:
        vals = iter(combo)
        tails.append(b"".join(c if isinstance(c, bytes)
                              else str(next(vals)).encode() for c in columns))
    width = max(len(t) for t in tails)
    table = np.zeros((len(tails), width), np.uint8)
    for i, t in enumerate(tails):
        table[i, :len(t)] = np.frombuffer(t, np.uint8)
    mat = torch.empty((m, k + width), dtype=torch.uint8, device=dev)
    mat[:, :k] = ascii_of_codes(codes)
    mat[:, k:] = torch.from_numpy(table).to(dev)[inv]
    return mat[mat != 0].cpu().numpy().tobytes()


def write_blocks(fh, blocks: Iterator[bytes], *, gzip_level: int = 0) -> int:
    """Write byte blocks in order; with ``gzip_level`` each block becomes
    one gzip member (a multi-member stream reads back as the blocks'
    concatenation), compressed in worker threads while the next blocks
    are made (zlib runs without the interpreter lock). Returns the
    uncompressed bytes."""
    n = 0
    if not gzip_level:
        for data in blocks:
            fh.write(data)
            n += len(data)
        return n
    workers = max(1, min(8, os.cpu_count() or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        pending: "collections.deque" = collections.deque()
        for data in blocks:
            n += len(data)
            pending.append(pool.submit(gzip.compress, data, gzip_level,
                                       mtime=0))
            while len(pending) > 2 * workers:
                fh.write(pending.popleft().result())
        while pending:
            fh.write(pending.popleft().result())
    return n


def write_rows(fh, codes, columns, *, device) -> int:
    """Write :func:`csv_bytes` rows block by block, formatted on ``device``
    (``codes`` and the integer columns are numpy arrays or tensors; a
    block is moved to ``device`` whole). Returns the bytes of text."""
    def blocks():
        for lo in range(0, codes.shape[0], ROWS_PER_BLOCK):
            hi = lo + ROWS_PER_BLOCK
            yield csv_bytes(
                torch.as_tensor(codes[lo:hi]).to(device),
                [c if isinstance(c, bytes) else torch.as_tensor(c[lo:hi])
                 for c in columns])
    return write_blocks(fh, blocks())


def write_count_table(
    directory: str,
    keys: torch.Tensor,
    counts: torch.Tensor,
    k: int,
    *,
    gzip_output: bool = True,
) -> str:
    """Write a ``Count_<k>``-style CSV (one part file) + _SUCCESS; ``keys``
    are ``(U,)`` int64 or ``(U, W)`` word rows, formatted on their device."""
    os.makedirs(directory, exist_ok=True)
    name = "part-00000.csv" + (".gz" if gzip_output else "")
    path = os.path.join(directory, name)

    def blocks():
        for lo in range(0, counts.shape[0], ROWS_PER_BLOCK):
            hi = lo + ROWS_PER_BLOCK
            yield csv_bytes(unpack_bases(keys[lo:hi], k),
                            [b",", counts[lo:hi], b"\n"])
    with open(path, "wb") as fh:
        write_blocks(fh, blocks(), gzip_level=GZIP_LEVEL if gzip_output
                     else 0)
    write_success_marker(directory)
    return path


def part_files(pattern: str) -> List[str]:
    """The files a table pattern names: each match itself, or a matched
    directory's ``part-*`` files in name order."""
    parts: List[str] = []
    for path in expand_paths(pattern):
        if os.path.isdir(path):
            parts += sorted(os.path.join(path, f) for f in os.listdir(path)
                            if f.startswith("part-"))
        else:
            parts.append(path)
    return parts


def read_count_table(pattern: str, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read ``KMERSTRING,count`` CSV files (plain or .gz) into ``(U,)``
    int64 keys (k <= 31) or ``(U, W)`` word rows, and int32 counts (CPU
    tensors)."""
    check_k(k)
    kmers = []
    counts = []
    for part in part_files(pattern):
        opener = gzip.open if part.endswith(".gz") else open
        with opener(part, "rt") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                km, _, cnt = line.partition(",")
                if km.startswith("("):
                    km = km[1:]
                cnt = cnt.rstrip(")")
                if len(km) != k:
                    raise ValueError(
                        f"k-mer length {len(km)} != k={k} in {part}")
                kmers.append(km)
                counts.append(min(int(cnt), 1_000_000_000))
    if not kmers:
        shape = (0,) if num_words(k) == 1 else (0, num_words(k))
        return (torch.zeros(shape, dtype=torch.int64),
                torch.zeros(0, dtype=torch.int32))
    codes = encode_ascii(
        np.frombuffer("".join(kmers).encode(), np.uint8)).reshape(-1, k)
    return (pack_bases(torch.from_numpy(codes), k),
            torch.tensor(counts, dtype=torch.int32))
