"""LSD radix sort of int64 keys: CUDA kernel wrapper + plain torch version.

Port of the TPU sort kernels in ``reflexiv_tpu/sort_kernels.py``
(``_local_sort_kernel``, ``_merge_block_kernel_factory`` and the static-stride
twins, run by ``sort_pairs_padded``); the kernel is
``reflexiv_tpu_torch/csrc/radix_sort.cu``. Contract: keys in ``[0, 2^bits)``
come back ascending; the counting pass's sentinel ``(1 << 2k) - 1`` is the
largest such value, so invalid windows end at the tail. Unlike
``sort_pairs_padded`` there is no power-of-two padding.
"""
from __future__ import annotations

import torch

LAUNCHES = 0   # kernel launches by sort_keys (one per call, all passes)
_RADIX = 256


def sort_keys_torch(keys: torch.Tensor) -> torch.Tensor:
    """Plain version: ``torch.sort`` (keys only, so ties are invisible)."""
    return torch.sort(keys).values


def sort_keys(keys: torch.Tensor, *, bits: int) -> torch.Tensor:
    """``(n,)`` int64 keys in ``[0, 2^bits)`` -> sorted copy.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`sort_keys_torch`. The input is never modified."""
    global LAUNCHES
    if not 1 <= bits <= 63:
        raise ValueError(f"bits={bits} must lie in [1, 63]")
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError(f"need 1-D int64 keys, got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    if keys.device.type == "cpu":
        return sort_keys_torch(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"keys on {keys.device}: need a CUDA or CPU tensor")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    n = keys.numel()
    if n >= 2**31:
        raise ValueError(f"{n} keys exceed the 2^31 bound of the offsets")
    if n == 0:
        return keys.clone()
    from . import build

    lib = build.lib()
    passes = (bits + 7) // 8
    nblocks = lib.rfx_radix_sort_blocks(n)
    buf0 = torch.empty_like(keys)
    buf1 = torch.empty_like(keys) if passes > 1 else buf0
    counts = torch.empty(_RADIX * nblocks, dtype=torch.int32, device=keys.device)
    totals = torch.empty(_RADIX, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.rfx_radix_sort_keys(
            keys.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
            counts.data_ptr(), totals.data_ptr(), n, bits, stream)
    build.check(err, "rfx_radix_sort_keys")
    LAUNCHES += 1
    return buf0 if (passes - 1) % 2 == 0 else buf1
