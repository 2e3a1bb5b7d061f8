"""One-pass FASTQ ingest (``csrc/ingest.cpp``), bound with ctypes.

Each file is inflated once, in blocks, and each block's reads parsed and
packed; the blocks' reads are then copied into the ``(reads, longest)``
matrix on several threads (:class:`FastqPass`). A gzip file of several
members is inflated a member to a thread on all of its threads, each
member confirmed by the chain of trailers before it; any other file (plain
text, one member, or a chain that fails) by one thread, while others
parse. The matrix and lengths equal ``native``'s two passes (``rfx_scan`` +
``rfx_load``) byte for byte; ``native.load_reads_native`` takes this path
for every file it reads as FASTQ, and the two passes for a file where zlib
reports a data error (``FastqPass.two_passes``), since those end the text
where ``read_line`` does.

The library is built on first use with plain ``g++`` and zlib:

    g++ -O3 -march=native -fPIC -shared -std=c++17 -Wall \\
        csrc/ingest.cpp -o build/ingest/<hash>/libreflexiv_ingest.so -lz -pthread

under ``build/`` beside the package (listed in ``.gitignore``), keyed by a
hash of the source, the flags and the host's CPU (``-march=native``), so a
changed source rebuilds and an unchanged one loads at once. When the build
or the load fails, :func:`lib` returns None and ingest keeps the two passes.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger("reflexiv_tpu_torch")

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(PKG_DIR, "csrc", "ingest.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "ingest")
LIB_NAME = "libreflexiv_ingest.so"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall"]
LINK_FLAGS = ["-lz", "-pthread"]

_I64P = ctypes.POINTER(ctypes.c_int64)

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _cpu_id() -> bytes:
    """The host CPU's model and flags, which ``-march=native`` compiles
    for (empty where ``/proc/cpuinfo`` cannot be read)."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return b""
    return b"\n".join(ln for ln in lines
                      if ln.startswith((b"model name", b"flags")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(_cpu_id())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library if this hash has none yet; returns its path.
    Raises OSError or subprocess.SubprocessError when the compile fails."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp,
                    *LINK_FLAGS], check=True, capture_output=True,
                   timeout=120)
    os.replace(tmp, lib_path)   # atomic: a concurrent build sees all or none
    return lib_path


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first call), or None when it cannot be
    built or loaded."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        handle = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("one-pass ingest unavailable (%s); reading FASTQ in "
                    "two passes", e)
        _build_failed = True
        return None
    handle.rfx_ingest_fastq.restype = ctypes.c_void_p
    handle.rfx_ingest_fastq.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, _I64P]
    handle.rfx_ingest_fill.restype = ctypes.c_int64
    handle.rfx_ingest_fill.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int]
    handle.rfx_ingest_free.restype = None
    handle.rfx_ingest_free.argtypes = [ctypes.c_void_p]
    _lib = handle
    return handle


class FastqPass:
    """One FASTQ file read in one pass on up to ``threads`` threads:
    ``reads``, ``longest``, the bytes of text ``inflated``, the seconds
    the inflating threads waited for a free block (``wait_s``), the gzip
    ``members`` the chain accepted (0 where one thread read the file), the
    ``inflate_threads``, the candidate member starts rejected
    (``false_starts``) and whether the chain failed and one thread read
    the file again (``fell_back``). Where zlib reported a data error,
    ``two_passes`` is set and nothing is held: the caller reads the file
    in the two passes. :meth:`fill` writes the reads into a matrix once,
    :meth:`close` frees them. ``block_bytes`` (0: the library's default)
    sets the size of the inflated blocks."""

    def __init__(self, handle: ctypes.CDLL, path: str, threads: int,
                 block_bytes: int = 0) -> None:
        info = np.zeros(9, np.int64)
        self._lib = handle
        self._pass = handle.rfx_ingest_fastq(
            path.encode(), block_bytes, threads, info.ctypes.data_as(_I64P))
        self.two_passes = bool(info[8])
        if not self._pass and not self.two_passes:
            raise OSError(f"one-pass ingest failed for {path}")
        self.path = path
        (self.reads, self.longest, self.inflated, wait_ns, self.members,
         self.inflate_threads, self.false_starts,
         self.fell_back) = (int(v) for v in info[:8])
        self.wait_s = wait_ns * 1e-9

    def fill(self, codes: np.ndarray, lens: np.ndarray, threads: int) -> None:
        """Write the reads into the first ``reads`` rows of ``codes`` (a
        zeroed, C-contiguous uint8 matrix at least ``longest`` wide) and of
        ``lens`` (int32)."""
        if (codes.dtype != np.uint8 or lens.dtype != np.int32
                or codes.ndim != 2 or lens.ndim != 1
                or not codes.flags.c_contiguous
                or not lens.flags.c_contiguous
                or codes.shape[0] < self.reads or lens.shape[0] < self.reads
                or codes.shape[1] < self.longest):
            raise ValueError("the matrix cannot hold this file's reads")
        got = self._lib.rfx_ingest_fill(
            self._pass, codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            codes.shape[1], threads)
        if got != self.reads:
            raise OSError(f"one-pass ingest fill failed for {self.path}")

    def close(self) -> None:
        if self._pass:
            self._lib.rfx_ingest_free(self._pass)
            self._pass = None
