"""Canonical k-mer counting (PyTorch counterpart of ``reflexiv_tpu.count``).

extract -> sort -> run-length count -> coverage band, the counterpart of
``count_pass_fused`` / ``sort_count_filter`` / ``_runlength_keep``
(``count.py:150-303``) and of the reference's ``groupBy("value").count()``
with coverage filters (``ReflexivDataFrameCounter.java:207-216``).

The table is ``(keys, counts)``: unique canonical int64 keys ascending and
int32 counts, on the device. ``bitpack.limbs_from_keys`` turns the keys
into the JAX package's ``(U, W)`` limb array, row for row. One pass counts
the whole matrix: the JAX package's streaming branch (``-partition``, or
over 2^27 windows) gives the same table exactly, so the flag changes
nothing here; streaming with spill is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bitpack import check_k
from .device import resolve_device
from .kernels import extract as extract_mod
from .kernels import radix_sort


def _as_device(x, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) \
        else x
    return t.to(device=device, dtype=dtype).contiguous()


def runlength_band(skeys: torch.Tensor, sentinel: int, min_cov: int,
                   max_cov: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted keys (sentinels at the tail) -> unique keys whose run length
    lies in ``[min_cov, max_cov]``, with those lengths as int32."""
    n_valid = int((skeys != sentinel).sum())
    valid = skeys[:n_valid]
    if n_valid == 0:
        return valid, torch.zeros(0, dtype=torch.int32, device=skeys.device)
    is_start = torch.ones(n_valid, dtype=torch.bool, device=skeys.device)
    is_start[1:] = valid[1:] != valid[:-1]
    starts = torch.nonzero(is_start).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([n_valid])])
    counts = ends - starts
    keep = (counts >= min_cov) & (counts <= max_cov)
    return valid[starts[keep]], counts[keep].to(torch.int32)


def count_kmers(
    bases,
    lengths,
    *,
    k: int,
    min_cov: int,
    max_cov: int = 10_000_000,
    front_clip: int = 0,
    end_clip: int = 0,
    device,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reads -> (unique canonical keys, counts) on ``device``.

    ``bases`` is a ``(R, L)`` uint8 code matrix and ``lengths`` ``(R,)``
    (numpy or tensors). On a CUDA device the extraction and the sort are
    the hand kernels; ``plain=True`` runs their plain torch versions
    instead (the reference the card's kernels are checked against)."""
    check_k(k)
    device = resolve_device(device)
    R, L = bases.shape
    n_windows = R * max(L - k + 1, 0)
    if n_windows >= 2**31:
        raise ValueError(f"{n_windows} k-mer windows exceed the 2^31 "
                         "single-pass bound")
    b = _as_device(bases, torch.uint8, device)
    lens = _as_device(lengths, torch.int32, device)
    if plain:
        keys = extract_mod.extract_canonical_keys_torch(
            b, lens, k=k, front_clip=front_clip, end_clip=end_clip)
        skeys = radix_sort.sort_keys_torch(keys)
    else:
        keys = extract_mod.extract_canonical_keys(
            b, lens, k=k, front_clip=front_clip, end_clip=end_clip)
        skeys = radix_sort.sort_keys(keys, bits=2 * k)
    del keys
    return runlength_band(skeys, extract_mod.sentinel(k), min_cov, max_cov)


def merge_count_tables(
    keys_a: torch.Tensor, counts_a: torch.Tensor,
    keys_b: torch.Tensor, counts_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two unique (key, count) tables into one sorted unique table,
    summing the counts of shared keys (``count.merge_count_tables``)."""
    keys = torch.cat([keys_a, keys_b])
    counts = torch.cat([counts_a, counts_b]).to(torch.int64)
    if keys.numel() == 0:
        return keys, counts.to(torch.int32)
    skeys, order = torch.sort(keys, stable=True)
    csum = torch.cumsum(counts[order], 0)
    is_start = torch.ones_like(skeys, dtype=torch.bool)
    is_start[1:] = skeys[1:] != skeys[:-1]
    starts = torch.nonzero(is_start).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([skeys.numel()])])
    before = torch.where(starts > 0, csum[(starts - 1).clamp(min=0)], 0)
    sums = csum[ends - 1] - before
    return skeys[starts], sums.clamp(max=2**31 - 1).to(torch.int32)
