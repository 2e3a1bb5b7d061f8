"""The radix-partition probe's pieces (PyTorch counterpart of ``reflexiv_tpu.partition_kernels``).

A partition pass groups each block of (hi, lo) pairs by the 8-bit digit
``(hi >> shift) & 0xFF`` (:func:`group_blocks`), then copies every (block,
digit) run into a padded bucket slot (:func:`padded_exchange`, a CUDA
kernel); :func:`compact_buckets` drops the slots' pad and alignment heads.
:func:`tile_gather` (a CUDA kernel) measures random aligned 4 KB tile loads.
The JAX package used these to decide whether a partition pass could
replace its counting sort (``partition_kernels.py:1-42``); the port runs
them as probes (``reflexiv_tpu_torch.probes``).

hi/lo are ``torch.int32`` tensors holding uint32 bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.partition import (N_DIGITS, TILE, padded_exchange,  # noqa: F401
                                padded_exchange_torch, slot_size,
                                tile_gather, tile_gather_torch)


def _unsigned_order_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of the uint32 pair
    (hi, lo): ``(hi ^ 2^31)`` read as a signed int32 times 2^32, plus lo.
    (``(hi << 32) | lo`` would overflow a signed int64.)"""
    hi_s = (hi ^ torch.iinfo(torch.int32).min).to(torch.int64)
    return hi_s * (1 << 32) + (lo.to(torch.int64) & 0xFFFFFFFF)


def group_blocks(hi: torch.Tensor, lo: torch.Tensor, *, block: int,
                 shift: int):
    """Block grouping + run-start table (``partition_kernels.group_blocks_xla``,
    plain torch as it was XLA there): sorts each ``block``-sized chunk by the
    unsigned pair (hi, lo) and returns ``(hi_g, lo_g, starts)``, ``starts``
    ``(nb * 256,)`` int32 the first position of each digit in each block
    (``searchsorted``, left). The digits must be nondecreasing within a
    sorted block, so ``shift`` is 24 (the top byte of hi), as in the probe."""
    if shift != 24:
        raise ValueError(f"shift={shift}: the run table needs the top byte "
                         "of hi (shift 24), which the sort orders")
    n = hi.shape[0]
    nb = n // block
    if nb * block != n or lo.shape != hi.shape:
        raise ValueError(f"{n} pairs are not a whole number of blocks of "
                         f"{block}")
    key = _unsigned_order_key(hi, lo).reshape(nb, block)
    order = torch.sort(key, dim=1).indices
    base = (torch.arange(nb, device=hi.device) * block)[:, None]
    flat = (order + base).reshape(-1)
    hi_g, lo_g = hi[flat], lo[flat]
    digits = (hi_g.to(torch.int64) & 0xFFFFFFFF).reshape(nb, block) >> shift
    bins = torch.arange(N_DIGITS, device=hi.device).expand(nb, N_DIGITS)
    starts = torch.searchsorted(digits.contiguous(), bins.contiguous(),
                                side="left")
    return hi_g, lo_g, starts.reshape(-1).to(torch.int32)


def compact_buckets(out_hi, out_lo, starts, *, nb: int, block: int,
                    maxrun: int):
    """Host-side check helper (``partition_kernels.compact_buckets_np``):
    drop the pad tails and alignment heads of every (d, b) slot and
    concatenate the buckets in digit order. numpy in, numpy out."""
    starts = np.asarray(starts).reshape(nb, N_DIGITS)
    ends = np.concatenate(
        [starts[:, 1:], np.full((nb, 1), block, np.int32)], axis=1)
    lens = ends - starts
    hi_parts, lo_parts = [], []
    oh = np.asarray(out_hi)
    ol = np.asarray(out_lo)
    slot = slot_size(maxrun)
    for d in range(N_DIGITS):
        for b in range(nb):
            src = b * block + int(starts[b, d])
            at = (d * nb + b) * slot + src % TILE
            n = int(lens[b, d])
            hi_parts.append(oh[at: at + n])
            lo_parts.append(ol[at: at + n])
    return np.concatenate(hi_parts), np.concatenate(lo_parts)
