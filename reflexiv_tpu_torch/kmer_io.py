"""On-disk k-mer table format: the reference's ``Count_<k>`` CSV (``reflexiv_tpu.kmer_io``).

``KMERSTRING,count`` rows in ``Count_<k>/part-00000.csv[.gz]`` plus a
``_SUCCESS`` marker (``ReflexivDataFrameCounter.java:216-233``); the reader
also takes the reference's parenthesised Spark tuple dumps
(``ReflexivDSMain.java:3883-3907``).
"""
from __future__ import annotations

import gzip
import os
from typing import Tuple

import numpy as np
import torch

from .bitpack import CODE_TO_BASE, check_k, encode_ascii, pack_bases, \
    unpack_bases
from .io import expand_paths, write_success_marker


def write_count_table(
    directory: str,
    keys: torch.Tensor,
    counts: torch.Tensor,
    k: int,
    *,
    gzip_output: bool = True,
) -> str:
    """Write a ``Count_<k>``-style CSV (one part file) + _SUCCESS."""
    os.makedirs(directory, exist_ok=True)
    name = "part-00000.csv" + (".gz" if gzip_output else "")
    path = os.path.join(directory, name)
    opener = gzip.open if gzip_output else open
    text = CODE_TO_BASE[unpack_bases(keys.cpu(), k).numpy()]   # (U, k) ASCII
    with opener(path, "wt") as fh:
        for row, c in zip(text, counts.cpu().tolist()):
            fh.write(f"{row.tobytes().decode()},{c}\n")
    write_success_marker(directory)
    return path


def read_count_table(pattern: str, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read ``KMERSTRING,count`` CSV files (plain or .gz) into int64 keys
    and int32 counts (CPU tensors)."""
    check_k(k)
    kmers = []
    counts = []
    for path in expand_paths(pattern):
        if os.path.isdir(path):
            parts = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.startswith("part-"))
        else:
            parts = [path]
        for part in parts:
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
        return (torch.zeros(0, dtype=torch.int64),
                torch.zeros(0, dtype=torch.int32))
    codes = encode_ascii(
        np.frombuffer("".join(kmers).encode(), np.uint8)).reshape(-1, k)
    return (pack_bases(torch.from_numpy(codes), k),
            torch.tensor(counts, dtype=torch.int32))
