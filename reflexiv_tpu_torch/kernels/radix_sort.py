"""LSD radix sort of int64 keys and of int64 word rows: CUDA kernel
wrappers + plain torch versions.

Port of the TPU sort kernels in ``reflexiv_tpu/sort_kernels.py``
(``_local_sort_kernel``, ``_merge_block_kernel_factory`` and the static-stride
twins, run by ``sort_pairs_padded``); the kernel is
``reflexiv_tpu_torch/csrc/radix_sort.cu``, a onesweep radix sort. Contract:
keys in ``[0, 2^bits)`` come back ascending; the counting pass's sentinel
``(1 << 2k) - 1`` is the largest such value, so invalid windows end at the
tail. Unlike ``sort_pairs_padded`` there is no power-of-two padding.
:func:`sort_rows` sorts the ``(n, W)`` word rows of k >= 32 (``bitpack``)
lexicographically: a onesweep over the leading word (:func:`lead_plan`),
then a tie pass inside its runs, by a warp for runs of at most
:data:`WARP_CAP` rows, by a CTA up to :data:`CTA_CAP`, and by the whole
row plan (:func:`pass_plan`) on the rows of longer runs only.

:func:`pass_plan` and :func:`lead_plan` are the one description of the
passes: the wrapper sizes and picks its buffers from them, and the kernel
follows them row by row. :data:`WARP_CAP` and :data:`CTA_CAP` repeat the
kernel's caps for the model in the tests; ``rfx_radix_sort_tie_cap``
gives the kernel's own, and a card test holds them equal.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

LAUNCHES = 0       # kernel launches by sort_keys (one per call, all passes)
ROW_LAUNCHES = {}  # kernel launches by sort_rows, by W (one per call)
MAX_N = 2**31 - 1  # offsets, indices and status counts are 32-bit
_RADIX = 256
_DIGIT_BITS = 8
_WORD_BITS = 62    # every word but the last is full
WRITE_KEYS = 1     # pass_plan flags
WRITE_ROWS = 2
WARP_CAP = 32      # rows of the longest run a warp sorts (the warp's width)
CTA_CAP = 8192     # rows of the longest run a CTA sorts in shared memory
                   # (the kernel's kWarpCap and kCtaCap)


def pass_plan(W: int, last_bits: int) -> np.ndarray:
    """The passes of a sort of ``(n, W)`` word rows (``W = 1``: keys) whose
    last word holds ``last_bits`` bits and every other word 62: an int32
    array of rows ``(word, shift, key_src, idx_src, dst, flags)``.

    Words go from the last to the first, ``ceil(bits / 8)`` passes each.
    ``key_src`` / ``idx_src`` is the buffer (0 or 1) the previous pass wrote,
    or -1: the key is fetched from the input through the index, and the
    index is the identity. Pass p writes buffer ``dst = (P - 1 - p) % 2``,
    so the last pass writes buffer 0: the sorted keys of a key sort. A row
    sort's passes carry the index; each word's last pass writes no keys
    (the next word is fetched), and the last pass writes the rows."""
    if not 1 <= W <= 4:
        raise ValueError(f"W={W} must lie in [1, 4]")
    if not 1 <= last_bits <= (63 if W == 1 else _WORD_BITS):
        raise ValueError(f"last_bits={last_bits} out of range for W={W}")
    passes = []
    for word in range(W - 1, -1, -1):
        bits = last_bits if word == W - 1 else _WORD_BITS
        n_word = -(-bits // _DIGIT_BITS)
        passes += [(word, _DIGIT_BITS * q, q == 0, q == n_word - 1)
                   for q in range(n_word)]
    P = len(passes)
    plan = np.empty((P, 6), np.int32)
    for p, (word, shift, first, last_of_word) in enumerate(passes):
        src, dst = (P - p) % 2, (P - 1 - p) % 2
        if W == 1:
            flags = WRITE_KEYS
        elif p == P - 1:
            flags = WRITE_ROWS
        else:
            flags = 0 if last_of_word else WRITE_KEYS
        plan[p] = (word, shift, -1 if first else src,
                   -1 if p == 0 or W == 1 else src, dst, flags)
    return plan


def lead_plan() -> np.ndarray:
    """The passes of a row sort's first step: (word 0, index) pairs
    through the 62 bits of the leading word, in :func:`pass_plan`'s row
    form. Every pass writes keys and index, the last into buffer 0: the
    tie pass reads both."""
    P = -(-_WORD_BITS // _DIGIT_BITS)
    plan = np.empty((P, 6), np.int32)
    for p in range(P):
        src, dst = (P - p) % 2, (P - 1 - p) % 2
        plan[p] = (0, _DIGIT_BITS * p, -1 if p == 0 else src,
                   -1 if p == 0 else src, dst, WRITE_KEYS)
    return plan


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
    _check(keys)
    if keys.shape[0] == 0:
        return keys.clone()
    n, plan = keys.shape[0], pass_plan(1, bits)
    buf0 = torch.empty_like(keys)
    buf1 = torch.empty_like(keys) if len(plan) > 1 else buf0
    hist, status = _scratch(keys.device, n, len(plan), pairs=0)
    build.launch("rfx_radix_sort_keys", keys.device, keys.data_ptr(),
                 buf0.data_ptr(), buf1.data_ptr(), hist.data_ptr(),
                 status.data_ptr(), n, plan.ctypes.data, len(plan))
    LAUNCHES += 1
    return buf0


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
    :func:`sort_rows_torch`. The input is never modified. The launcher waits
    on the stream once, for the count of runs longer than :data:`CTA_CAP`
    (the host sorts their list), so the call returns once every step but
    the sort of those runs has run on the card."""
    if not 1 <= last_bits <= _WORD_BITS:
        raise ValueError(f"last_bits={last_bits} must lie in [1, 62]")
    if rows.dim() != 2 or rows.dtype != torch.int64 or \
            not 2 <= rows.shape[1] <= 4:
        raise TypeError(f"need (n, W) int64 rows with 2 <= W <= 4, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return sort_rows_torch(rows)
    _check(rows)
    if rows.shape[0] == 0:
        return rows.clone()
    (n, W), plan = rows.shape, pass_plan(rows.shape[1], last_bits)
    lead = lead_plan()
    keys = [torch.empty(n, dtype=torch.int64, device=rows.device)
            for _ in range(2)]
    idx = [torch.empty(n, dtype=torch.int32, device=rows.device)
           for _ in range(2)]
    out = torch.empty_like(rows)
    hist, status = _scratch(rows.device, n, len(plan), pairs=1)
    build.launch("rfx_radix_sort_rows", rows.device, rows.data_ptr(),
                 keys[0].data_ptr(), keys[1].data_ptr(), idx[0].data_ptr(),
                 idx[1].data_ptr(), out.data_ptr(), hist.data_ptr(),
                 status.data_ptr(), n, W, lead.ctypes.data, len(lead),
                 plan.ctypes.data, len(plan))
    ROW_LAUNCHES[W] = ROW_LAUNCHES.get(W, 0) + 1
    return out


def _check(keys: torch.Tensor) -> None:
    """Refuse what the kernel cannot take: more than MAX_N elements,
    another device, a strided tensor."""
    if keys.shape[0] > MAX_N:
        raise ValueError(f"{keys.shape[0]} keys exceed the {MAX_N} bound of "
                         "the 32-bit offsets")
    if keys.device.type != "cuda":
        raise ValueError(f"keys on {keys.device}: need a CUDA or CPU tensor")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")


def _scratch(device, n: int, passes: int, *, pairs: int):
    """The digit tables (``passes * 256`` uint32) and the look-back status
    words (256 per tile, then the tile counter)."""
    tiles = -(-n // build.lib().rfx_radix_sort_tile(pairs))
    hist = torch.empty(passes * _RADIX, dtype=torch.int32, device=device)
    status = torch.empty(tiles * _RADIX + 1, dtype=torch.int64, device=device)
    return hist, status
