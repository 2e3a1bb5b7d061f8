"""ctypes loader for the shared native C++ IO library (``native/``).

The same ``native/libreflexiv_native.so`` that ``reflexiv_tpu.native``
loads, built on demand with ``make -C native`` (g++ + zlib). Only the read
decoder is bound here: :func:`load_reads_native` decodes FASTQ/FASTA files
straight into 2-bit code matrices. Returns None when the library cannot be
built or loaded, and :func:`reflexiv_tpu_torch.io.load_reads` then uses the
Python readers.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("reflexiv_tpu_torch")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libreflexiv_native.so")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False

SPLIT_MIN_BYTES = 32 << 20   # split single plain FASTQ files above this
_N_THREADS = max(2, min(16, os.cpu_count() or 2))
_I64P = ctypes.POINTER(ctypes.c_int64)


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
    _lib = lib
    return lib


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
    GIL), and a large plain FASTQ file is also byte-range split at record
    boundaries and parsed by several threads. Returns None when the native
    library is unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    threads = threads or _N_THREADS

    split_paths = {}
    if fmt == 0:
        for p in paths:
            if _is_plain_fastq(p) and os.path.getsize(p) >= SPLIT_MIN_BYTES:
                split_paths[p] = _splits_of(lib, p, threads)

    def scan_one(path):
        if path in split_paths:
            a = split_paths[path]
            ns = len(a) - 1
            counts = np.zeros(ns, np.int64)
            maxlens = np.zeros(ns, np.int64)
            lib.rfx_fastq_scan_mt(
                path.encode(), a.ctypes.data_as(_I64P), ns,
                counts.ctypes.data_as(_I64P), maxlens.ctypes.data_as(_I64P))
            return int(counts.sum()), int(maxlens.max(initial=0)), counts
        n, mx = _scan(lib, path, fmt)
        return n, mx, None

    with ThreadPoolExecutor(max_workers=threads) as pool:
        scans = list(pool.map(scan_one, paths))

    total = sum(n for n, _m, _c in scans)
    stride = max((m for _n, m, _c in scans), default=0)
    codes = np.zeros((total, stride), dtype=np.uint8)
    lens = np.zeros(total, dtype=np.int32)
    starts = np.cumsum([0] + [n for n, _m, _c in scans])

    def load_one(i):
        path = paths[i]
        n, _mx, counts = scans[i]
        at = int(starts[i])
        if counts is not None:
            a = split_paths[path]
            row_off = at + np.concatenate(
                [[0], np.cumsum(counts[:-1])]).astype(np.int64)
            got = lib.rfx_fastq_load_mt(
                path.encode(), a.ctypes.data_as(_I64P),
                row_off.ctypes.data_as(_I64P), len(a) - 1,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                stride,
            )
        else:
            got = lib.rfx_load(
                path.encode(), fmt,
                codes[at:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lens[at:].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                n, stride,
            )
        if got < 0:
            raise OSError(f"native load failed for {path}")
        return int(got)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        gots = list(pool.map(load_one, range(len(paths))))
    if sum(gots) != total:
        # scan and load parse identically, so a mismatch means the input
        # changed mid-read: rows would be misplaced in the matrix
        raise OSError(f"native load row mismatch for {paths}")
    return codes, lens
