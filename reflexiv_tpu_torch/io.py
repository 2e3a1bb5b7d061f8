"""Host-side sequence IO (the host half of ``reflexiv_tpu.io``, without jax).

FASTQ/FASTA readers into a ``(R, L)`` uint8 2-bit code matrix plus lengths,
and the FASTA contig / ``_SUCCESS`` writers. Replaces the reference's
Spark-side file plumbing (``ReflexivDSMain.java:4037-4072``,
``:715-795``). Everything here is numpy; the caller moves the matrix to its
device.
"""
from __future__ import annotations

import glob as _glob
import gzip
import os
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from .bitpack import encode_ascii


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".bz2"):
        import bz2

        return bz2.open(path, "rb")
    return open(path, "rb")


def expand_paths(pattern: str) -> List[str]:
    """Expand a comma-separated list of glob patterns."""
    paths: List[str] = []
    for pat in pattern.split(","):
        hits = sorted(_glob.glob(pat))
        if not hits and os.path.exists(pat):
            hits = [pat]
        paths.extend(hits)
    if not paths:
        raise FileNotFoundError(f"no input files match: {pattern}")
    fourmc = [p for p in paths if p.endswith(".4mc")]
    if fourmc:
        raise ValueError(
            "hadoop-4mc container input is not supported: "
            + ", ".join(fourmc)
            + " — decompress to FASTQ/FASTA (plain, .gz or .bz2) first")
    return paths


def iter_fastq(paths: Iterable[str]) -> Iterator[bytes]:
    """Yield read sequences (bytes) from FASTQ files (plain, .gz or .bz2)."""
    for path in paths:
        with _open_maybe_gzip(path) as fh:
            while True:
                header = fh.readline()
                if not header:
                    break
                seq = fh.readline().strip()
                fh.readline()  # +
                fh.readline()  # qual
                if seq:
                    yield seq


def iter_fasta(paths: Iterable[str]) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, sequence bytes) from FASTA files (plain, .gz or .bz2)."""
    for path in paths:
        name = None
        chunks: List[bytes] = []
        with _open_maybe_gzip(path) as fh:
            for raw in fh:
                line = raw.strip()
                if line.startswith(b">"):
                    if name is not None:
                        yield name, b"".join(chunks)
                    name = line[1:].decode()
                    chunks = []
                elif line:
                    chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def reads_to_matrix(seqs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-length reads into a (R, Lmax) uint8 code matrix + lengths.
    Pad value is 0 (=='A'); padded columns are masked out by the lengths."""
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=n)
    lmax = int(lens.max()) if n else 0
    mat = np.zeros((n, lmax), dtype=np.uint8)
    for i, s in enumerate(seqs):
        mat[i, : lens[i]] = encode_ascii(np.frombuffer(s, dtype=np.uint8))
    return mat, lens


def load_reads(pattern: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load FASTQ (or FASTA if no FASTQ records are found) reads into a code
    matrix, through the native C++ decoder when it builds, else the Python
    readers (same matrix either way)."""
    from . import native

    paths = expand_paths(pattern)
    if not any(p.endswith(".bz2") for p in paths):
        try:
            out = native.load_reads_native(paths, fmt=0)
            if out is not None and out[0].shape[0] == 0:
                out = native.load_reads_native(paths, fmt=1)
            if out is not None and out[0].shape[0] > 0:
                return out
        except OSError:
            pass
    seqs = list(iter_fastq(paths))
    if not seqs:
        seqs = [s for _, s in iter_fasta(paths)]
    return reads_to_matrix(seqs)


def load_reads_filtered(pattern: str, params) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`load_reads` + the shared input read filters: ``-minlength``
    (drop short reads) and ``-reads`` (keep only the first N)."""
    mat, lens = load_reads(pattern)
    if params.min_read_length > 0:
        keep = lens >= params.min_read_length
        mat, lens = mat[keep], lens[keep]
    if params.read_limit > 0:
        mat, lens = mat[: params.read_limit], lens[: params.read_limit]
    return mat, lens


def contigs_to_segment_matrix(
    contigs: Sequence[str], *, k: int, seg: int = 2048
) -> Tuple[np.ndarray, np.ndarray]:
    """Contigs -> fixed-width row matrix of (k-1)-overlap segments; the
    k-mer multiset is preserved exactly (``io.contigs_to_segment_matrix``)."""
    seg = max(seg, 2 * k)
    step = seg - (k - 1)
    pieces: List[bytes] = []
    for s in contigs:
        if len(s) < k + 2:
            continue  # <2 k-mers: below the pass's read filter, like reads
        b = s.encode()
        starts = list(range(0, max(len(b) - (k - 1), 1), step))
        segs = [b[lo: lo + seg] for lo in starts]
        if len(segs) >= 2 and len(segs[-1]) < k + 2:
            segs[-2] = b[starts[-2]:]
            segs.pop()
        pieces.extend(segs)
    if not pieces:
        return np.zeros((0, seg), np.uint8), np.zeros(0, np.int32)
    return reads_to_matrix(pieces)


def wrap_sequence(seq: str, width: int = 100) -> str:
    """100-column FASTA wrapping (``ReflexivDSMain.java:773-794``)."""
    return "\n".join(seq[i : i + width] for i in range(0, len(seq), width))


def write_contigs_fasta(
    path: str,
    contigs: Sequence[Tuple[str, str]],
    gzip_output: bool = False,
) -> None:
    """Write (id_line, sequence) contigs as FASTA; IDs follow the reference
    format ``>Contig-<len>-(<left>,<right>)-<idx>``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    opener = gzip.open if gzip_output else open
    with opener(path, "wt") as fh:
        for cid, seq in contigs:
            fh.write(f"{cid}\n{wrap_sequence(seq)}\n")


def write_success_marker(directory: str) -> None:
    """Stage-completion marker, as Spark's ``_SUCCESS`` files."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "_SUCCESS"), "w"):
        pass


def has_success_marker(directory: str) -> bool:
    """Whether a stage directory holds its ``_SUCCESS`` marker."""
    return os.path.exists(os.path.join(directory, "_SUCCESS"))
