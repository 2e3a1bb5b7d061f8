"""Canonical k-mer counting (PyTorch counterpart of ``reflexiv_tpu.count``).

extract -> sort -> run-length count -> coverage band, the counterpart of
``count_pass_fused`` / ``sort_count_filter`` / ``_runlength_keep``
(``count.py:150-303``) and of the reference's ``groupBy("value").count()``
with coverage filters (``ReflexivDataFrameCounter.java:207-216``).

The table is ``(keys, counts)``: unique canonical keys ascending and int32
counts, on the device. Keys are ``(U,)`` int64 for k <= 31 and ``(U, W)``
int64 word rows for 32 <= k <= 99 (``bitpack``); ``bitpack.limbs_from_keys``
turns either into the JAX package's ``(U, ceil(k/16))`` limb array, row for
row. One pass counts the whole matrix: the JAX package's streaming branch
(``-partition``, or over 2^27 windows, ``dynamic.count_kmers_auto``) gives
the same table exactly, so the flag changes nothing here; streaming with
spill is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bitpack import check_k, num_words, word_bases
from .device import resolve_device
from .join_core import lexsort_rows, segments
from .kernels import extract as extract_mod
from .kernels import radix_sort


def _as_device(x, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) \
        else x
    return t.to(device=device, dtype=dtype).contiguous()


def runlength_band(skeys: torch.Tensor, sentinel, min_cov: int,
                   max_cov: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted ``(N,)`` keys or ``(N, W)`` rows (sentinels at the tail) ->
    unique keys whose run length lies in ``[min_cov, max_cov]``, with those
    lengths as int32."""
    is_sent = skeys == torch.as_tensor(sentinel, device=skeys.device)
    n_valid = skeys.shape[0] - int(
        (is_sent.all(-1) if skeys.dim() == 2 else is_sent).sum())
    valid = skeys[:n_valid]
    if n_valid == 0:
        return valid, torch.zeros(0, dtype=torch.int32, device=skeys.device)
    is_start, _seg = segments(valid)
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
    """Reads -> (unique canonical keys, counts) on ``device``; keys are
    ``(U,)`` for k <= 31 and ``(U, W)`` word rows above.

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
    clips = dict(k=k, front_clip=front_clip, end_clip=end_clip)
    if num_words(k) == 1 and plain:
        keys = extract_mod.extract_canonical_keys_torch(b, lens, **clips)
        skeys = radix_sort.sort_keys_torch(keys)
    elif num_words(k) == 1:
        keys = extract_mod.extract_canonical_keys(b, lens, **clips)
        skeys = radix_sort.sort_keys(keys, bits=2 * k)
    elif plain:
        keys = extract_mod.extract_canonical_rows_torch(b, lens, **clips)
        skeys = radix_sort.sort_rows_torch(keys)
    else:
        keys = extract_mod.extract_canonical_rows(b, lens, **clips)
        skeys = radix_sort.sort_rows(keys, last_bits=2 * word_bases(k)[-1])
    del keys
    return runlength_band(skeys, extract_mod.sentinel(k), min_cov, max_cov)


def merge_count_tables(
    keys_a: torch.Tensor, counts_a: torch.Tensor,
    keys_b: torch.Tensor, counts_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two unique (key, count) tables (``(U,)`` keys or ``(U, W)``
    rows) into one sorted unique table, summing the counts of shared keys
    (``count.merge_count_tables``)."""
    keys = torch.cat([keys_a, keys_b])
    counts = torch.cat([counts_a, counts_b]).to(torch.int64)
    if keys.shape[0] == 0:
        return keys, counts.to(torch.int32)
    order = lexsort_rows(keys)
    skeys = keys[order]
    csum = torch.cumsum(counts[order], 0)
    is_start, _seg = segments(skeys)
    starts = torch.nonzero(is_start).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([skeys.shape[0]])])
    before = torch.where(starts > 0, csum[(starts - 1).clamp(min=0)], 0)
    sums = csum[ends - 1] - before
    return skeys[starts], sums.clamp(max=2**31 - 1).to(torch.int32)


def count_kmers_auto(bases, lengths, *, k: int, min_cov: int, max_cov: int,
                     front_clip: int = 0, end_clip: int = 0,
                     partitions: int = 0, device, plain: bool = False):
    """``dynamic.count_kmers_auto``: the JAX package streams the count in
    row chunks past 2^27 windows or under ``-partition``; the table is the
    same, so this is one :func:`count_kmers` pass (``partitions`` is
    accepted and changes nothing)."""
    del partitions
    return count_kmers(bases, lengths, k=k, min_cov=min_cov, max_cov=max_cov,
                       front_clip=front_clip, end_clip=end_clip,
                       device=device, plain=plain)
