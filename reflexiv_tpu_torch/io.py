"""Host-side sequence IO (the host half of ``reflexiv_tpu.io``, without jax).

FASTQ/FASTA readers into a ``(R, L)`` uint8 2-bit code matrix plus lengths,
bounded read chunks straight from disk for out-of-core counting
(:func:`iter_read_chunks`, under ``REFLEXIV_INGEST_BUDGET_MB``), and the
FASTA contig / ``_SUCCESS`` writers (contigs spelled on the device are
written from their bytes). Replaces the reference's
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


def iter_fastq_with_quals(paths: Iterable[str]
                          ) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (sequence, quality string) byte pairs from FASTQ files, for
    quality-aware correction (``-trustqual``)."""
    for path in paths:
        with _open_maybe_gzip(path) as fh:
            while True:
                header = fh.readline()
                if not header:
                    break
                seq = fh.readline().strip()
                fh.readline()  # +
                qual = fh.readline().strip()
                if seq:
                    yield seq, qual


def load_reads_with_quals(pattern: str
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FASTQ reads and their phred scores: ``(codes, lens, quals)``, where
    ``quals`` is an (R, L) uint8 matrix of ASCII - 33 floored at 0, aligned
    with the code matrix (pad 0). Python reader only."""
    seqs: List[bytes] = []
    quals: List[bytes] = []
    for s, q in iter_fastq_with_quals(expand_paths(pattern)):
        seqs.append(s)
        quals.append(q)
    mat, lens = reads_to_matrix(seqs)
    qmat = np.zeros_like(mat)
    for i, q in enumerate(quals):
        n = min(len(q), int(lens[i]))
        if n:
            arr = np.frombuffer(q[:n], np.uint8).astype(np.int16) - 33
            qmat[i, :n] = np.clip(arr, 0, 255).astype(np.uint8)
    return mat, lens, qmat


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


def ingest_budget_bytes() -> int:
    """Out-of-core ingest budget from ``REFLEXIV_INGEST_BUDGET_MB`` (0, the
    default, or a value that is not an integer: off, whole-matrix
    loading). When set, ``counter``, ``run``, ``reduce`` and ``meta``'s
    stage 00 count bounded chunks streamed from disk
    (``io.ingest_budget_bytes``)."""
    try:
        return int(os.environ.get("REFLEXIV_INGEST_BUDGET_MB", "0")) << 20
    except ValueError:
        return 0


def scan_max_read_length(pattern: str) -> int:
    """Longest read across the input, without loading it: the native
    one-pass scan where it applies, else the incremental readers
    (``io.scan_max_read_length``)."""
    from . import native

    lib = native._get_lib()
    best = 0
    for path in expand_paths(pattern):
        if lib is not None and not path.endswith(".bz2"):
            try:
                n, mx = native._scan(lib, path, 0)
                if n == 0:
                    _n, mx = native._scan(lib, path, 1)
                best = max(best, mx)
                continue
            except OSError:
                pass
        for s in _iter_sequences(path):
            best = max(best, len(s))
    return best


def _sniff_fasta(path: str) -> bool:
    with _open_maybe_gzip(path) as fh:
        return fh.read(1) == b">"


def _iter_sequences(path: str) -> Iterator[bytes]:
    """One file's read sequences, FASTA or FASTQ by its first byte."""
    if _sniff_fasta(path):
        return (s for _, s in iter_fasta([path]))
    return iter_fastq([path])


def iter_read_chunks(
    pattern: str, params=None, *, budget_bytes: int = 1 << 30,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(codes, lens)`` read matrices of about ``budget_bytes`` of
    input each, in file order, straight from disk
    (``io.iter_read_chunks``): plain FASTQ through the native byte-range
    splitter (:func:`native.iter_split_chunks`), gzip, bz2 and FASTA
    through the incremental readers. ``params`` applies the ``-minlength``
    and ``-reads`` filters on the fly, so the chunks' rows are
    :func:`load_reads_filtered`'s rows.

    A chunk is as wide as its longest read and holds only real rows: the
    JAX package pads rows to a power of two and the width to a multiple of
    32 to bound its recompiles, which changes no table."""
    from . import native

    minlen = params.min_read_length if params is not None else 0
    remaining = (params.read_limit
                 if params is not None and params.read_limit > 0 else None)

    def finish(mat, lens):
        nonlocal remaining
        if minlen > 0:
            keep = lens >= minlen
            mat, lens = mat[keep], lens[keep]
        if remaining is not None:
            mat, lens = mat[:remaining], lens[:remaining]
            remaining -= len(lens)
        return (mat, lens) if len(lens) else None

    buf: List[bytes] = []
    cells = 0

    def flush():
        nonlocal buf, cells
        got = finish(*reads_to_matrix(buf)) if buf else None
        buf, cells = [], 0
        return got

    for path in expand_paths(pattern):
        if remaining == 0:
            break
        split_iter = native.iter_split_chunks(path, budget_bytes)
        if split_iter is not None:
            pending = flush()
            if pending is not None:
                yield pending
            for mat, lens in split_iter:
                if remaining == 0:
                    break
                got = finish(mat, lens)
                if got is not None:
                    yield got
            continue
        for seq in _iter_sequences(path):
            buf.append(seq)
            cells += max(len(seq), 1)
            if cells >= budget_bytes:
                got = flush()
                if got is not None:
                    yield got
                if remaining == 0:
                    break
    got = flush()
    if got is not None:
        yield got


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


FASTA_LINE = 100   # bases a FASTA line


def wrap_sequence(seq: str, width: int = FASTA_LINE) -> str:
    """100-column FASTA wrapping (``ReflexivDSMain.java:773-794``)."""
    return "\n".join(seq[i : i + width] for i in range(0, len(seq), width))


def write_contigs_fasta(
    path: str,
    contigs: Sequence[Tuple[str, str]],
    gzip_output: bool = False,
) -> None:
    """Write (id_line, sequence) contigs as FASTA; IDs follow the reference
    format ``>Contig-<len>-(<left>,<right>)-<idx>``. Contigs that carry the
    FASTA bodies the device spelled for them (``contigs.EmittedContigs``)
    are written from those, a header line and a slice of the bodies each;
    any other list from its strings. The bytes are the same."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    opener = gzip.open if gzip_output else open
    spelled = getattr(contigs, "spelled", None)
    if spelled is None:
        with opener(path, "wt") as fh:
            for cid, seq in contigs:
                fh.write(f"{cid}\n{wrap_sequence(seq)}\n")
        return
    bodies = (body for chunk in spelled for body in chunk.fasta_bodies())
    with opener(path, "wb") as fh:
        for (cid, _seq), body in zip(contigs, bodies):
            fh.write(f"{cid}\n".encode())
            fh.write(body)


def write_success_marker(directory: str) -> None:
    """Stage-completion marker, as Spark's ``_SUCCESS`` files."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "_SUCCESS"), "w"):
        pass


def has_success_marker(directory: str) -> bool:
    """Whether a stage directory holds its ``_SUCCESS`` marker."""
    return os.path.exists(os.path.join(directory, "_SUCCESS"))
