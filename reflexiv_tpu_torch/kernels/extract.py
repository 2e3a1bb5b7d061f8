"""Canonical k-mer extraction: CUDA kernel wrappers + plain torch versions.

Port of the TPU kernel ``reflexiv_tpu/pallas_kernels.py:_extract_kernel``
(``extract_canonical_kmers_pallas``); the kernel is
``reflexiv_tpu_torch/csrc/extract_kmers.cu``. Output: one key per window of
the ``(R, L)`` code matrix, row-major ``(read, window)``, with invalid
windows set to poly-T (:func:`sentinel`). k <= 31 takes
:func:`extract_canonical_keys` (one int64 per window); 32 <= k <= 99 takes
:func:`extract_canonical_rows` (``W = ceil(k/31)`` int64 words per window,
the layout of ``bitpack``).

Codes are 0..3 (A, C, G, T), as ``bitpack.encode_ascii`` makes them; the
kernel reads only the low two bits of each byte.

The kernel packs each CTA's reads once into shared memory and cuts every
key from the packed streams; :func:`launch_geometry` picks how many reads
a CTA takes (or, for rows longer than :data:`STAGE_BASES`, how many
windows of one read) and the shared memory that needs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bitpack import (MAX_K, RUN_MAX_K, BASES_PER_WORD, canonical_keys,
                       canonical_rows, check_k, num_words, poly_t, word_bases)
from . import build

LAUNCHES = 0       # kernel launches by extract_canonical_keys (one word)
ROW_LAUNCHES = {}  # kernel launches by extract_canonical_rows, by W

THREADS = 256          # per CTA (csrc/extract_kmers.cu kThreads)
STAGE_BASES = 16384    # code bytes a CTA stages at most (about 8 KB packed)
MAX_READS = 1024       # reads per CTA at most (8 KB of window bounds)


class Geometry(NamedTuple):
    reads: int        # reads per CTA (1 where a row is split)
    windows: int      # windows per read per CTA (L - k + 1 unless split)
    ctas_per_read: int
    smem_bytes: int   # dynamic shared memory per CTA


def launch_geometry(L: int, k: int) -> Geometry:
    """The kernel's launch shape for rows of ``L`` bases at ``k``: whole
    reads per CTA, as many as fit in :data:`STAGE_BASES` bytes (at most
    :data:`MAX_READS`), or, for a
    longer row, ``STAGE_BASES - k + 1`` windows of one read per CTA. Shared
    memory: the two packed streams of the span (16 bases per uint32, at
    any 16-byte offset, two zero words after each), 8 bytes of window
    bounds per read, and for W >= 2 the warps' output stages. The launcher
    recomputes the size and refuses a launch that it would not hold."""
    W = num_words(k)
    wn = L - k + 1
    if L <= STAGE_BASES:
        reads, windows = min(STAGE_BASES // L, MAX_READS), wn
        span = reads * L
    else:
        reads, windows = 1, STAGE_BASES - k + 1
        span = STAGE_BASES
    smem = (8 * ((span + 30) // 16 + 2) + 8 * reads
            + (8 * THREADS * W if W > 1 else 0))
    return Geometry(reads, windows, -(-wn // windows), smem)


def sentinel(k: int):
    """Invalid-window key: poly-T, never canonical (its reverse complement
    poly-A is smaller), with every bit of every word set so it sorts last:
    ``(1 << 2k) - 1`` for k <= 31, a list of W words above."""
    return poly_t(k)


def _window_count(bases: torch.Tensor, k: int) -> int:
    if bases.dim() != 2:
        raise ValueError(f"bases must be (R, L), got shape {tuple(bases.shape)}")
    wn = bases.shape[1] - k + 1
    if wn <= 0:
        raise ValueError(f"read matrix width {bases.shape[1]} shorter than k={k}")
    return wn


def extract_canonical_keys_torch(
    bases: torch.Tensor, lengths: torch.Tensor, *, k: int,
    front_clip: int = 0, end_clip: int = 0,
) -> torch.Tensor:
    """Plain version: shifted slice-OR over the whole matrix, as
    ``reflexiv_tpu.count.count_pass_fused`` (``count.py:265-285``)."""
    check_k(k, RUN_MAX_K)
    wn = _window_count(bases, k)
    R = bases.shape[0]
    fwd = torch.zeros((R, wn), dtype=torch.int64, device=bases.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        col = bases[:, j: j + wn].to(torch.int64)
        fwd |= col << (2 * (k - 1 - j))
        rc |= (col ^ 3) << (2 * j)
    key = canonical_keys(fwd, rc)
    valid = _valid_windows(lengths, wn, k, front_clip, end_clip)
    return torch.where(valid, key, sentinel(k)).reshape(-1)


def _valid_windows(lengths, wn, k, front_clip, end_clip):
    """(R, wn) window validity (``count.py:282-285``)."""
    w_idx = torch.arange(wn, device=lengths.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    read_ok = (lens - k - end_clip > 1) & (front_clip <= lens)
    return read_ok & (w_idx >= front_clip) & (w_idx + k <= lens - end_clip)


def extract_canonical_rows_torch(
    bases: torch.Tensor, lengths: torch.Tensor, *, k: int,
    front_clip: int = 0, end_clip: int = 0,
) -> torch.Tensor:
    """Plain version of :func:`extract_canonical_rows`: shifted slice-OR
    per word, as ``reflexiv_tpu.count.count_pass_fused`` does per limb."""
    check_k(k)
    if num_words(k) < 2:
        raise ValueError(f"k={k}: rows are for k > {RUN_MAX_K}")
    wn = _window_count(bases, k)
    R = bases.shape[0]
    fwd, rc = [], []
    for i, n in enumerate(word_bases(k)):
        lo = BASES_PER_WORD * i
        f = torch.zeros((R, wn), dtype=torch.int64, device=bases.device)
        c = torch.zeros_like(f)
        for j in range(n):
            sh = 2 * (n - 1 - j)
            f |= bases[:, lo + j: lo + j + wn].to(torch.int64) << sh
            m = k - 1 - lo - j
            c |= (bases[:, m: m + wn].to(torch.int64) ^ 3) << sh
        fwd.append(f)
        rc.append(c)
    key = canonical_rows(torch.stack(fwd, -1), torch.stack(rc, -1))
    del fwd, rc
    valid = _valid_windows(lengths, wn, k, front_clip, end_clip)
    sent = torch.tensor(sentinel(k), dtype=torch.int64, device=bases.device)
    return torch.where(valid[..., None], key, sent).reshape(R * wn, -1)


def extract_canonical_keys(
    bases: torch.Tensor, lengths: torch.Tensor, *, k: int,
    front_clip: int = 0, end_clip: int = 0,
) -> torch.Tensor:
    """``(R, L)`` uint8 codes + ``(R,)`` int32 lengths -> ``(R * (L-k+1),)``
    int64 canonical keys (sentinel where invalid).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`extract_canonical_keys_torch`."""
    global LAUNCHES
    check_k(k, RUN_MAX_K)
    _window_count(bases, k)
    if bases.device.type == "cpu" and lengths.device.type == "cpu":
        return extract_canonical_keys_torch(
            bases, lengths, k=k, front_clip=front_clip, end_clip=end_clip)
    out = _launch("rfx_extract_canonical_keys", bases, lengths, k,
                  front_clip, end_clip, ())
    LAUNCHES += 1
    return out


def extract_canonical_rows(
    bases: torch.Tensor, lengths: torch.Tensor, *, k: int,
    front_clip: int = 0, end_clip: int = 0,
) -> torch.Tensor:
    """``(R, L)`` uint8 codes + ``(R,)`` int32 lengths -> ``(R * (L-k+1), W)``
    int64 canonical keys (poly-T rows where invalid), 32 <= k <= 99.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`extract_canonical_rows_torch`."""
    check_k(k, MAX_K)
    if num_words(k) < 2:
        raise ValueError(f"k={k}: rows are for k > {RUN_MAX_K}")
    _window_count(bases, k)
    if bases.device.type == "cpu" and lengths.device.type == "cpu":
        return extract_canonical_rows_torch(
            bases, lengths, k=k, front_clip=front_clip, end_clip=end_clip)
    out = _launch("rfx_extract_canonical_rows", bases, lengths, k,
                  front_clip, end_clip, (num_words(k),))
    W = num_words(k)
    ROW_LAUNCHES[W] = ROW_LAUNCHES.get(W, 0) + 1
    return out


def _launch(fn, bases, lengths, k, front_clip, end_clip, word_shape):
    """Check the arguments, allocate the output and launch ``fn``."""
    if bases.device.type != "cuda" or lengths.device != bases.device:
        raise ValueError(f"bases on {bases.device}, lengths on "
                         f"{lengths.device}: both must be on one CUDA device")
    if bases.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError(f"need uint8 bases and int32 lengths, got "
                        f"{bases.dtype} / {lengths.dtype}")
    if not (bases.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("bases and lengths must be contiguous")
    R, L = bases.shape
    if lengths.shape != (R,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({R},)")
    if front_clip < 0 or end_clip < 0:
        raise ValueError("clips must be >= 0")
    wn = L - k + 1
    out = torch.empty((R * wn,) + word_shape, dtype=torch.int64,
                      device=bases.device)
    geo = launch_geometry(L, k)
    build.launch(fn, bases.device, bases.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), R, L, k, front_clip, end_clip, geo.reads,
                 geo.windows, geo.smem_bytes)
    return out
