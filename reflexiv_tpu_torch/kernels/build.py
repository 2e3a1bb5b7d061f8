"""Build and load the hand-written CUDA kernels (``reflexiv_tpu_torch/csrc``).

At first use, every ``csrc/*.cu`` file is compiled by its own ``nvcc``,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o <build>/<hash>/<name>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o <build>/<hash>/libreflexiv_kernels.so <build>/<hash>/*.o

The build directory is ``build/kernels/<hash>`` beside the package (listed
in ``.gitignore``), keyed by a hash of the sources and the flags, so a
changed source rebuilds and an unchanged one loads at once. Any failure
(no ``nvcc``, a compile error, a load error) raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
LIB_NAME = "libreflexiv_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C signatures of the kernels' launchers; the launchers return
# cudaGetLastError() (0 on success), the tile query a size
_SIGNATURES = {
    # (bases, lengths, out, R, L, k, front_clip, end_clip, reads, windows,
    #  smem_bytes, stream)
    "rfx_extract_canonical_keys": [_P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                                   _I32, _I32, _I32, _P],
    "rfx_extract_canonical_rows": [_P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                                   _I32, _I32, _I32, _P],
    # (keys_in, buf0, buf1, hist, status, n, plan (host), passes, stream)
    "rfx_radix_sort_keys": [_P, _P, _P, _P, _P, _I64, _P, _I32, _P],
    # (rows_in, keys0, keys1, idx0, idx1, out, hist, status, n, W,
    #  plan (host), passes, stream)
    "rfx_radix_sort_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _P,
                            _I32, _P],
    # (hi, lo, starts, out_hi, out_lo, nb, block, slot, stream)
    "rfx_padded_exchange": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    # (src, tile_starts, out, n_tiles, stream)
    "rfx_tile_gather": [_P, _P, _P, _I64, _P],
    # (pairs) -> elements per onesweep tile of the radix sort
    "rfx_radix_sort_tile": [_I32],
}

_lib: Optional[ctypes.CDLL] = None
_one_card: Optional[bool] = None   # set at the first launch
last_build_seconds: float = 0.0   # 0.0 when the library came from the cache


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine with the card")


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library path."""
    global last_build_seconds
    srcs = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs))
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        last_build_seconds = 0.0
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in srcs:
        obj = os.path.join(out_dir, os.path.basename(src)[:-3]
                           + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, lib_path)   # atomic: a concurrent build sees all or none
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        # PyDLL keeps the GIL across the call: the launchers only enqueue
        # work and return, and releasing and taking the GIL back would
        # cost a small kernel's call more host time than the launch
        handle = ctypes.PyDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, device, *args) -> None:
    """Call launcher ``name`` with ``args`` and ``device``'s current stream
    (its last argument), with ``device`` current; raise on its CUDA error
    code.

    Kept cheap on the host, where a 10 us kernel's call is decided: the raw
    stream handle (``torch._C._cuda_getCurrentRawStream``, as PyTorch's own
    generated kernels take it) costs 0.1 us where building a
    ``torch.cuda.Stream`` costs about 5 (scripts/torch_kernel_profile.py on
    the H100's host, PERF.md); the device switch happens only where ``device``
    is not current, and a machine with one card has nothing to switch."""
    global _one_card
    import torch

    fn = getattr(lib(), name)
    if _one_card is None:
        _one_card = torch.cuda.device_count() == 1
    current = 0 if _one_card else torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
