"""Plain FASTQ and FASTA readers for the reference and the judge: the
standard library's gzip and NumPy, nothing of the program."""
from __future__ import annotations

import gzip

import numpy as np

_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i   # lower case


def read_fastq_codes(path: str) -> np.ndarray:
    """Every read of a (gzipped) FASTQ file as an ``(R, L)`` uint8 matrix of
    2-bit codes. The reads have to share one length and hold only A, C, G
    and T: the benchmark's traffic makes no other, and anything else raises
    rather than being read some other way than the program reads it."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        buf = np.frombuffer(fh.read(), np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    if len(nl) % 4:
        raise ValueError(f"{path}: {len(nl)} lines, not whole FASTQ records")
    starts = np.concatenate([[0], nl[:-1] + 1])
    seq_lo, seq_hi = starts[1::4], nl[1::4]
    if len(seq_lo) == 0:
        raise ValueError(f"{path}: no reads")
    if not (buf[starts[0::4]] == ord("@")).all():
        raise ValueError(f"{path}: a record does not start with '@'")
    lens = seq_hi - seq_lo
    L = int(lens[0])
    if not (lens == L).all():
        raise ValueError(f"{path}: reads of several lengths")
    codes = np.empty((len(seq_lo), L), np.uint8)
    cols = np.arange(L)
    for lo in range(0, len(seq_lo), 1 << 19):
        block = _CODE[buf[seq_lo[lo:lo + (1 << 19), None] + cols]]
        if (block == 255).any():
            raise ValueError(f"{path}: a base other than A, C, G, T")
        codes[lo:lo + len(block)] = block
    return codes


def read_fasta(path: str) -> list:
    """``(header, sequence)`` pairs of a FASTA file, sequence lines joined."""
    out, head, parts = [], None, []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if head is not None:
                    out.append((head, "".join(parts)))
                head, parts = line, []
            elif line:
                parts.append(line)
    if head is not None:
        out.append((head, "".join(parts)))
    return out


_RC = str.maketrans("ACGTacgt", "TGCAtgca")


def canonical(seq: str) -> str:
    """The lesser of a sequence and its reverse complement."""
    rc = seq.translate(_RC)[::-1]
    return seq if seq <= rc else rc
