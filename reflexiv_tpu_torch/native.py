"""ctypes loader for the shared native C++ IO library (``native/``).

The same ``native/libreflexiv_native.so`` that ``reflexiv_tpu.native``
loads, built on demand with ``make -C native`` (g++ + zlib). Bound here:
:func:`load_reads_native` decodes FASTQ/FASTA files straight into 2-bit
code matrices, :func:`iter_split_chunks` streams a plain FASTQ file in
bounded byte-range chunks, :func:`dedup_contigs_native` drops contigs contained in
longer ones, patching's four entries (:func:`end_index_native`,
:func:`map_pairs_hashed_native`, :func:`map_pairs_native`,
:func:`best_overlap_native`), and preprocessing's pair overlap
(:func:`merge_pairs_native`) and k-mer-spectrum correction
(:func:`correct_reads_native`). Each returns None when the library cannot
be built or loaded; the callers then use their Python versions.

``rfx_map_seeds`` (``reflexiv_tpu.native.map_seeds_native``) is not bound:
``patching.patch_contigs`` cannot reach it with the library present. Its
one caller, ``_map_reads_arrays``, runs only when the native pair mappers
are off (``REFLEXIV_NATIVE_PATCH=0`` or ``REFLEXIV_DEVICE_STAGES=0``, which
also skip ``rfx_map_seeds``) or when the patching map runs on the device.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from . import ingest, metrics

log = logging.getLogger("reflexiv_tpu_torch")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libreflexiv_native.so")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_N_THREADS = max(2, min(16, os.cpu_count() or 2))
_I64P = ctypes.POINTER(ctypes.c_int64)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    src = os.path.join(_NATIVE_DIR, "reflexiv_native.cpp")
    stale = (
        os.path.exists(_SO_PATH) and os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(_SO_PATH)
    )
    if not os.path.exists(_SO_PATH) or stale:
        if not os.path.exists(src):
            _build_failed = True
            return None
        try:
            if stale:
                os.remove(_SO_PATH)
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True,
                capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native build failed (%s); using Python IO", e)
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        log.warning("native load failed (%s); using Python IO", e)
        _build_failed = True
        return None
    lib.rfx_scan.restype = ctypes.c_int
    lib.rfx_scan.argtypes = [ctypes.c_char_p, ctypes.c_int, _I64P, _I64P]
    lib.rfx_load.restype = ctypes.c_int64
    lib.rfx_load.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.rfx_fastq_splits.restype = ctypes.c_int
    lib.rfx_fastq_splits.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I64P]
    lib.rfx_fastq_scan_mt.restype = ctypes.c_int
    lib.rfx_fastq_scan_mt.argtypes = [
        ctypes.c_char_p, _I64P, ctypes.c_int64, _I64P, _I64P]
    lib.rfx_fastq_load_mt.restype = ctypes.c_int64
    lib.rfx_fastq_load_mt.argtypes = [
        ctypes.c_char_p, _I64P, _I64P, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.rfx_dedup.restype = ctypes.c_int64
    lib.rfx_dedup.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), _I64P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
    ]
    # patching: the ten outputs of a pair mapping are, per mate, (contig
    # int64, end int8, pos int64, strand int8, mapped uint8)
    mate_outs = [_I64P, _I8P, _I64P, _I8P, _U8P] * 2
    lib.rfx_end_index.restype = ctypes.c_int64
    lib.rfx_end_index.argtypes = [
        _U8P, _I64P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _U64P, _I64P, _I8P, _I64P, _I8P, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.rfx_map_pairs_hashed.restype = ctypes.c_int32
    lib.rfx_map_pairs_hashed.argtypes = [
        _U8P, _I64P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _U8P, _I64P, _U8P, _I64P, ctypes.c_int64, ctypes.c_int32,
        *mate_outs, ctypes.c_int32,
    ]
    lib.rfx_map_pairs.restype = None
    lib.rfx_map_pairs.argtypes = [
        _U8P, _I64P, _U8P, _I64P, ctypes.c_int64,
        _U64P, ctypes.c_int64, _I64P, _I8P, _I64P, _I8P,
        ctypes.c_int32, ctypes.c_int32, *mate_outs, ctypes.c_int32,
    ]
    lib.rfx_best_overlap.restype = ctypes.c_int32
    lib.rfx_best_overlap.argtypes = [
        _U8P, ctypes.c_int64, _U8P, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.rfx_merge_pairs.restype = None
    lib.rfx_merge_pairs.argtypes = [
        _U8P, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        _U8P, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rfx_correct.restype = ctypes.c_int64
    lib.rfx_correct.argtypes = [
        _U8P, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        _U64P, ctypes.c_int64, ctypes.c_int32, _U8P, ctypes.c_int32,
        ctypes.c_int32,
    ]
    _lib = lib
    return lib


def dedup_contigs_native(contigs: List[str], *,
                         seed_k: int = 31) -> Optional[List[str]]:
    """Containment dedup over both strands in C++ (``rfx_dedup``, a seed
    every 16 bases), the same semantics as :func:`reflexiv_tpu_torch.meta.dedup_contigs_python`
    on the same longest-first order; None when the library is missing."""
    from .bitpack import encode_ascii

    lib = _get_lib()
    if lib is None:
        return None
    ordered = sorted(set(contigs), key=len, reverse=True)
    if not ordered:
        return []
    offsets = np.zeros(len(ordered) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in ordered], out=offsets[1:])
    codes = encode_ascii(np.frombuffer("".join(ordered).encode(), np.uint8))
    keep = np.zeros(len(ordered), dtype=np.uint8)
    got = lib.rfx_dedup(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(_I64P), len(ordered), seed_k, 16,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if got < 0:
        return None
    return [s for s, k in zip(ordered, keep) if k]


def _scan(lib, path: str, fmt: int) -> Tuple[int, int]:
    n = ctypes.c_int64(0)
    mx = ctypes.c_int64(0)
    rc = lib.rfx_scan(path.encode(), fmt, ctypes.byref(n), ctypes.byref(mx))
    if rc != 0:
        raise OSError(f"native scan failed for {path}")
    return int(n.value), int(mx.value)


def _is_plain_fastq(path: str) -> bool:
    if path.endswith(".gz"):
        return False
    try:
        with open(path, "rb") as fh:
            return fh.read(1) == b"@"
    except OSError:
        return False


def _splits_of(lib, path: str, nsplits: int) -> np.ndarray:
    aligned = np.zeros(nsplits + 1, np.int64)
    rc = lib.rfx_fastq_splits(
        path.encode(), nsplits, aligned.ctypes.data_as(_I64P))
    if rc != 0:
        raise OSError(f"native split scan failed for {path}")
    return aligned


def load_reads_native(
    paths: List[str], fmt: int = 0, threads: int = 0
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode FASTQ (fmt=0) / FASTA (fmt=1) files into (codes, lens).

    Files decode concurrently on a thread pool (the C calls release the
    GIL), their rows in path order. As FASTQ, each file is read in one
    pass where its library builds (:class:`ingest.FastqPass`: a gzip file
    of several members inflated a member to a thread, any other file on
    one thread; parsed and packed on the others), else in two passes
    (``rfx_scan``, ``rfx_load``), as FASTA always is, and as a file is
    where zlib reports a data error. Files read at once share ``threads``
    (at least two each) rather than take as many each. Returns None when
    the native library is unavailable.
    Stages (timers, and ranges on a profiler's clock): ``ingest/scan``,
    the pass over the files (one pass: inflate, parse, pack into blocks;
    two passes: the first, counting the records and the longest);
    ``ingest/load``, building the matrix (its allocation and first-touch
    faults, and the one pass's parallel fill from the blocks or the
    second pass: inflate again, parse, pack). Counters: files read in one
    pass (``ingest/one_pass_files``), the bytes they inflated
    (``ingest/inflated_bytes``), the gzip members their chains accepted
    (``ingest/members``), the most threads that inflated one file
    (``ingest/inflate_threads``), the candidate member starts rejected
    (``ingest/false_member_starts``), the files whose chain failed and
    that one thread read again (``ingest/member_fallbacks``), and the
    timer ``ingest/inflate_wait_s``, the time their inflating threads
    waited for a free block, summed over the threads.
    """
    lib = _get_lib()
    if lib is None:
        return None
    threads = threads or _N_THREADS
    one_pass = ingest.lib() if fmt == 0 else None
    passes: List[ingest.FastqPass] = []   # freed whatever happens
    per_file = max(2, threads // max(1, len(paths)))
    at_once = threads if one_pass is None else max(1, threads // per_file)

    def scan_one(path):
        """``(reads, longest, the one pass or None for two passes)``"""
        if one_pass is not None:
            got = ingest.FastqPass(one_pass, path, per_file)
            passes.append(got)
            if not got.two_passes:
                return got.reads, got.longest, got
        n, mx = _scan(lib, path, fmt)
        return n, mx, None

    def load_one(i):
        path = paths[i]
        n, _mx, part = scans[i]
        at = int(starts[i])
        if part is not None:
            part.fill(codes[at:], lens[at:], per_file)
            return n
        got = lib.rfx_load(
            path.encode(), fmt,
            codes[at:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens[at:].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, stride,
        )
        if got < 0:
            raise OSError(f"native load failed for {path}")
        return int(got)

    met = metrics.current()
    try:
        with met.stage("ingest/scan", quiet=True), ThreadPoolExecutor(
                max_workers=at_once) as pool:
            scans = list(pool.map(scan_one, paths))

        total = sum(n for n, _m, _p in scans)
        stride = max((m for _n, m, _p in scans), default=0)
        starts = np.cumsum([0] + [n for n, _m, _p in scans])

        with met.stage("ingest/load", quiet=True):
            codes = np.zeros((total, stride), dtype=np.uint8)
            lens = np.zeros(total, dtype=np.int32)
            with ThreadPoolExecutor(max_workers=at_once) as pool:
                gots = list(pool.map(load_one, range(len(paths))))
    finally:
        for got in passes:
            got.close()
    if sum(gots) != total:
        # scan and load parse identically, so a mismatch means the input
        # changed mid-read: rows would be misplaced in the matrix
        raise OSError(f"native load row mismatch for {paths}")
    read = [got for got in passes if not got.two_passes]
    met.add("ingest/one_pass_files", len(read))
    met.add("ingest/inflated_bytes", sum(got.inflated for got in read))
    met.add_time("ingest/inflate_wait_s", sum(got.wait_s for got in read))
    met.add("ingest/members", sum(got.members for got in read))
    met.set("ingest/inflate_threads", max(
        [met.counts.get("ingest/inflate_threads", 0)]
        + [got.inflate_threads for got in read]))
    met.add("ingest/false_member_starts",
            sum(got.false_starts for got in passes))
    met.add("ingest/member_fallbacks", sum(got.fell_back for got in passes))
    return codes, lens


def iter_split_chunks(path: str, budget_bytes: int):
    """``(codes, lens)`` matrices of one plain FASTQ file, one per byte
    range of about ``budget_bytes``, each parsed only when the generator
    reaches it (``native.iter_split_chunks``): host memory holds one
    range's matrix, never the file's. Each range is cut again into up to
    ``_N_THREADS`` record-aligned pieces parsed by as many threads.
    Returns None (the caller takes the Python reader) when the library is
    missing or the file is not plain FASTQ."""
    lib = _get_lib()
    if lib is None or not _is_plain_fastq(path):
        return None
    size = os.path.getsize(path)
    nsplits = max(1, -(-size // max(budget_bytes, 1 << 20)))
    per = max(1, min(_N_THREADS, size // (1 << 20)))
    aligned = _splits_of(lib, path, nsplits * per)

    def gen():
        for i in range(nsplits):
            sub = np.ascontiguousarray(aligned[i * per: (i + 1) * per + 1])
            counts = np.zeros(per, np.int64)
            maxlens = np.zeros(per, np.int64)
            lib.rfx_fastq_scan_mt(
                path.encode(), sub.ctypes.data_as(_I64P), per,
                counts.ctypes.data_as(_I64P), maxlens.ctypes.data_as(_I64P))
            n, mx = int(counts.sum()), int(maxlens.max())
            if n == 0:
                continue
            codes = np.zeros((n, mx), np.uint8)
            lens = np.zeros(n, np.int32)
            row_off = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(
                np.int64)
            got = lib.rfx_fastq_load_mt(
                path.encode(), sub.ctypes.data_as(_I64P),
                row_off.ctypes.data_as(_I64P), per,
                codes.ctypes.data_as(_U8P),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), mx)
            if got != n:
                raise OSError(f"native split load mismatch for {path}")
            yield codes, lens

    return gen()


# ---------------------------------------------------------------------------
# patching
# ---------------------------------------------------------------------------

def _ragged_ascii(strs) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated latin-1 bytes of ``strs`` and their (n + 1) offsets."""
    off = np.zeros(len(strs) + 1, np.int64)
    np.cumsum([len(s) for s in strs], out=off[1:])
    return np.frombuffer("".join(strs).encode("latin-1"), np.uint8), off


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _mate_outputs(n: int) -> List[np.ndarray]:
    """Zeroed (contig, end, pos, strand, mapped) arrays for both mates."""
    return [np.zeros(n, dt) for dt in (np.int64, np.int8, np.int64, np.int8,
                                       np.uint8) * 2]


def _mate_pointers(outs: List[np.ndarray]) -> list:
    types = (ctypes.c_int64, ctypes.c_int8, ctypes.c_int64, ctypes.c_int8,
             ctypes.c_uint8) * 2
    return [_ptr(a, t) for a, t in zip(outs, types)]


def _mapped_as_bool(outs: List[np.ndarray]) -> tuple:
    outs[4] = outs[4].astype(bool)
    outs[9] = outs[9].astype(bool)
    return tuple(outs)


def end_index_native(contigs: List[str], *, k: int, end_window: int,
                     threads: int = 0):
    """Patching's end-window seed index in threaded C++ (``rfx_end_index``):
    the contents of :func:`reflexiv_tpu_torch.patching._end_index_arrays`
    (sorted unique uint64 keys and aligned ci/end/pos/strand, the first
    placement winning, (contig, end)-ambiguous keys dropped). Returns the
    five arrays, or None when the library is missing or k > 31."""
    lib = _get_lib()
    if lib is None or k > 31:
        return None
    ascii_cat, offsets = _ragged_ascii(contigs)
    cap = max(sum(4 * (min(end_window, len(s)) - k + 1) for s in contigs
                  if min(end_window, len(s)) >= k), 1)
    keys = np.empty(cap, np.uint64)
    ci = np.empty(cap, np.int64)
    end = np.empty(cap, np.int8)
    pos = np.empty(cap, np.int64)
    strand = np.empty(cap, np.int8)
    got = lib.rfx_end_index(
        _ptr(ascii_cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        len(contigs), k, end_window, _ptr(keys, ctypes.c_uint64),
        _ptr(ci, ctypes.c_int64), _ptr(end, ctypes.c_int8),
        _ptr(pos, ctypes.c_int64), _ptr(strand, ctypes.c_int8), cap,
        threads or _N_THREADS)
    if got < 0:
        return None
    return keys[:got], ci[:got], end[:got], pos[:got], strand[:got]


def map_pairs_hashed_native(contigs: List[str], pairs, *, k: int,
                            end_window: int, stride: int, threads: int = 0):
    """Patching's whole mapping front end in one C++ call
    (``rfx_map_pairs_hashed``): a hashed end-window index, then both mates
    of every pair mapped against it. Output-identical to
    :func:`end_index_native` + :func:`map_pairs_native`. Returns the ten
    mapping arrays, or None when the library is missing or k > 31."""
    lib = _get_lib()
    if lib is None or k > 31:
        return None
    cascii, coff = _ragged_ascii(contigs)
    a1, off1 = _ragged_ascii([r1 for r1, _ in pairs])
    a2, off2 = _ragged_ascii([r2 for _, r2 in pairs])
    outs = _mate_outputs(len(pairs))
    rc = lib.rfx_map_pairs_hashed(
        _ptr(cascii, ctypes.c_uint8), _ptr(coff, ctypes.c_int64),
        len(contigs), k, end_window,
        _ptr(a1, ctypes.c_uint8), _ptr(off1, ctypes.c_int64),
        _ptr(a2, ctypes.c_uint8), _ptr(off2, ctypes.c_int64), len(pairs),
        stride, *_mate_pointers(outs), threads or _N_THREADS)
    if rc != 0:
        return None
    return _mapped_as_bool(outs)


def map_pairs_native(pairs, keys: np.ndarray, ci: np.ndarray,
                     end: np.ndarray, pos: np.ndarray, strand: np.ndarray,
                     *, k: int, stride: int, threads: int = 0):
    """Both mates of every pair mapped against a sorted end-window index in
    C++ (``rfx_map_pairs``): mate 1 forward, mate 2 reverse complement,
    straight from the pair strings. Returns the ten mapping arrays, or
    None when the library is missing or k > 31."""
    lib = _get_lib()
    if lib is None or k > 31:
        return None
    a1, off1 = _ragged_ascii([r1 for r1, _ in pairs])
    a2, off2 = _ragged_ascii([r2 for _, r2 in pairs])
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    ci64 = np.ascontiguousarray(ci, dtype=np.int64)
    end8 = np.ascontiguousarray(end, dtype=np.int8)
    pos64 = np.ascontiguousarray(pos, dtype=np.int64)
    strand8 = np.ascontiguousarray(strand, dtype=np.int8)
    outs = _mate_outputs(len(pairs))
    lib.rfx_map_pairs(
        _ptr(a1, ctypes.c_uint8), _ptr(off1, ctypes.c_int64),
        _ptr(a2, ctypes.c_uint8), _ptr(off2, ctypes.c_int64), len(pairs),
        _ptr(keys, ctypes.c_uint64), len(keys), _ptr(ci64, ctypes.c_int64),
        _ptr(end8, ctypes.c_int8), _ptr(pos64, ctypes.c_int64),
        _ptr(strand8, ctypes.c_int8), k, stride, *_mate_pointers(outs),
        threads or _N_THREADS)
    return _mapped_as_bool(outs)


def best_overlap_native(a: bytes, b: bytes,
                        min_overlap: int) -> Optional[int]:
    """Longest exact tail(a)/head(b) overlap of at least ``min_overlap``
    (0 = none), ``rfx_best_overlap``; None when the library is missing."""
    lib = _get_lib()
    if lib is None:
        return None
    aa = np.frombuffer(a, np.uint8)
    bb = np.frombuffer(b, np.uint8)
    return int(lib.rfx_best_overlap(_ptr(aa, ctypes.c_uint8), len(aa),
                                    _ptr(bb, ctypes.c_uint8), len(bb),
                                    min_overlap))


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def merge_pairs_native(m1: np.ndarray, l1: np.ndarray, m2: np.ndarray,
                       l2: np.ndarray, *, min_overlap: int,
                       max_mismatch: float) -> Optional[np.ndarray]:
    """Best overlap length per pair (0 = unmerged), ``rfx_merge_pairs``:
    mate 1 forward against mate 2's reverse complement. None when the
    library is missing."""
    lib = _get_lib()
    if lib is None:
        return None
    m1 = np.ascontiguousarray(m1, dtype=np.uint8)
    m2 = np.ascontiguousarray(m2, dtype=np.uint8)
    l1 = np.ascontiguousarray(l1, dtype=np.int32)
    l2 = np.ascontiguousarray(l2, dtype=np.int32)
    if m2.shape[0] != m1.shape[0] or l1.shape != (m1.shape[0],) \
            or l2.shape != (m2.shape[0],):
        raise ValueError("mate matrices and lengths disagree in rows")
    best = np.zeros(m1.shape[0], dtype=np.int32)
    lib.rfx_merge_pairs(
        _ptr(m1, ctypes.c_uint8), _ptr(l1, ctypes.c_int32), m1.shape[1],
        _ptr(m2, ctypes.c_uint8), _ptr(l2, ctypes.c_int32), m2.shape[1],
        m1.shape[0], min_overlap, max_mismatch, _ptr(best, ctypes.c_int32))
    return best


def correct_reads_native(mat: np.ndarray, lens: np.ndarray,
                         solid_sorted: np.ndarray, *, k: int,
                         quals: np.ndarray = None, trust_qual: int = 0,
                         threads: int = 0):
    """In-place threaded k-mer-spectrum correction, ``rfx_correct``: the
    in-order per-read scan of ``preprocess.correct_reads_scalar`` against
    the sorted uint64 solid values. Returns ``(matrix, n_fixed)``, or None
    when the library is missing or k > 31."""
    lib = _get_lib()
    if lib is None or k > 31:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    if lens32.shape != (mat.shape[0],):
        raise ValueError("lengths do not match the read matrix")
    solid = np.ascontiguousarray(solid_sorted, dtype=np.uint64)
    qp = None
    if quals is not None and trust_qual > 0:
        quals = np.ascontiguousarray(quals, dtype=np.uint8)
        if quals.shape != mat.shape:
            raise ValueError("quality matrix does not match the reads")
        qp = _ptr(quals, ctypes.c_uint8)
    n_fixed = lib.rfx_correct(
        _ptr(mat, ctypes.c_uint8), _ptr(lens32, ctypes.c_int32),
        mat.shape[0], mat.shape[1], _ptr(solid, ctypes.c_uint64),
        len(solid), k, qp, int(trust_qual), threads or _N_THREADS)
    return mat, int(n_fixed)
