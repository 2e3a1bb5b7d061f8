"""Canonical k-mer extraction: CUDA kernel wrapper + plain torch version.

Port of the TPU kernel ``reflexiv_tpu/pallas_kernels.py:_extract_kernel``
(``extract_canonical_kmers_pallas``); the kernel is
``reflexiv_tpu_torch/csrc/extract_kmers.cu``. Output: one int64 key per
window of the ``(R, L)`` code matrix, row-major ``(read, window)``, with
invalid windows set to :func:`sentinel` ``(1 << 2k) - 1``.
"""
from __future__ import annotations

import torch

from ..bitpack import canonical_keys, check_k

LAUNCHES = 0   # kernel launches by extract_canonical_keys


def sentinel(k: int) -> int:
    """Invalid-window key: poly-T, never canonical (its reverse complement
    poly-A is 0), with every one of the 2k bits set so it sorts last."""
    return (1 << (2 * k)) - 1


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
    check_k(k)
    wn = _window_count(bases, k)
    R = bases.shape[0]
    fwd = torch.zeros((R, wn), dtype=torch.int64, device=bases.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        col = bases[:, j: j + wn].to(torch.int64)
        fwd |= col << (2 * (k - 1 - j))
        rc |= (col ^ 3) << (2 * j)
    key = canonical_keys(fwd, rc)
    w_idx = torch.arange(wn, device=bases.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    read_ok = (lens - k - end_clip > 1) & (front_clip <= lens)
    valid = read_ok & (w_idx >= front_clip) & (w_idx + k <= lens - end_clip)
    return torch.where(valid, key, sentinel(k)).reshape(-1)


def extract_canonical_keys(
    bases: torch.Tensor, lengths: torch.Tensor, *, k: int,
    front_clip: int = 0, end_clip: int = 0,
) -> torch.Tensor:
    """``(R, L)`` uint8 codes + ``(R,)`` int32 lengths -> ``(R * (L-k+1),)``
    int64 canonical keys (sentinel where invalid).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`extract_canonical_keys_torch`."""
    global LAUNCHES
    check_k(k)
    wn = _window_count(bases, k)
    if bases.device.type == "cpu" and lengths.device.type == "cpu":
        return extract_canonical_keys_torch(
            bases, lengths, k=k, front_clip=front_clip, end_clip=end_clip)
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
    from . import build

    out = torch.empty(R * wn, dtype=torch.int64, device=bases.device)
    with torch.cuda.device(bases.device):
        stream = torch.cuda.current_stream(bases.device).cuda_stream
        err = build.lib().rfx_extract_canonical_keys(
            bases.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            R, L, k, front_clip, end_clip, stream)
    build.check(err, "rfx_extract_canonical_keys")
    LAUNCHES += 1
    return out
