"""LSD radix sort of int64 keys and of int64 word rows: CUDA kernel
wrappers + plain torch versions.

Port of the TPU sort kernels in ``reflexiv_tpu/sort_kernels.py``
(``_local_sort_kernel``, ``_merge_block_kernel_factory`` and the static-stride
twins, run by ``sort_pairs_padded``); the kernel is
``reflexiv_tpu_torch/csrc/radix_sort.cu``. Contract: keys in ``[0, 2^bits)``
come back ascending; the counting pass's sentinel ``(1 << 2k) - 1`` is the
largest such value, so invalid windows end at the tail. Unlike
``sort_pairs_padded`` there is no power-of-two padding. :func:`sort_rows`
sorts the ``(n, W)`` word rows of k >= 32 (``bitpack``) lexicographically,
LSD over the words from the last to the first.
"""
from __future__ import annotations

import torch

LAUNCHES = 0       # kernel launches by sort_keys (one per call, all passes)
ROW_LAUNCHES = {}  # kernel launches by sort_rows, by W (one per call)
_RADIX = 256
_WORD_BITS = 62    # every word but the last is full


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
    out = _launch(keys, (bits + 7) // 8, "rfx_radix_sort_keys", bits)
    LAUNCHES += 1
    return out


def sort_rows_torch(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sort_rows`: chained stable ``torch.sort``
    over the words, last word first."""
    order = torch.arange(rows.shape[0], device=rows.device)
    for w in range(rows.shape[1] - 1, -1, -1):
        order = order[torch.sort(rows[order, w], stable=True).indices]
    return rows[order]


def sort_rows(rows: torch.Tensor, *, last_bits: int) -> torch.Tensor:
    """``(n, W)`` int64 rows, 2 <= W <= 4, every word in ``[0, 2^62)`` and
    the last in ``[0, 2^last_bits)`` -> a copy sorted lexicographically
    over the words.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`sort_rows_torch`. The input is never modified."""
    if not 1 <= last_bits <= _WORD_BITS:
        raise ValueError(f"last_bits={last_bits} must lie in [1, 62]")
    if rows.dim() != 2 or rows.dtype != torch.int64 or \
            not 2 <= rows.shape[1] <= 4:
        raise TypeError(f"need (n, W) int64 rows with 2 <= W <= 4, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return sort_rows_torch(rows)
    W = rows.shape[1]
    passes = (W - 1) * ((_WORD_BITS + 7) // 8) + (last_bits + 7) // 8
    out = _launch(rows, passes, "rfx_radix_sort_rows", W, last_bits)
    ROW_LAUNCHES[W] = ROW_LAUNCHES.get(W, 0) + 1
    return out


def _launch(keys: torch.Tensor, passes: int, fn: str, *args) -> torch.Tensor:
    """Check ``keys`` (one word per element or rows), allocate the two
    ping-pong buffers and the digit tables, and run ``passes`` passes of
    ``fn``; returns the buffer the last pass wrote."""
    if keys.device.type != "cuda":
        raise ValueError(f"keys on {keys.device}: need a CUDA or CPU tensor")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    n = keys.shape[0]
    if n >= 2**31:
        raise ValueError(f"{n} keys exceed the 2^31 bound of the offsets")
    if n == 0:
        return keys.clone()
    from . import build

    lib = build.lib()
    nblocks = lib.rfx_radix_sort_blocks(n)
    buf0 = torch.empty_like(keys)
    buf1 = torch.empty_like(keys) if passes > 1 else buf0
    counts = torch.empty(_RADIX * nblocks, dtype=torch.int32, device=keys.device)
    totals = torch.empty(_RADIX, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = getattr(lib, fn)(
            keys.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
            counts.data_ptr(), totals.data_ptr(), n, *args, stream)
    build.check(err, fn)
    return buf0 if (passes - 1) % 2 == 0 else buf1
