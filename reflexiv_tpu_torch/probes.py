"""Partition-exchange probes on the card (the ``partition_exchange`` and
``element_gather`` phases of ``scripts/tpu_round4_bench.py:188-262``).

    from reflexiv_tpu_torch import probes
    probes.partition_exchange_probe("cuda", seed=0)
    probes.element_gather_probe("cuda", seed=0)

They measure the two primitives a radix partition pass would compose
into: the padded run-copy exchange (:func:`partition_kernels.padded_exchange`)
after a per-block grouping, and random aligned 4 KB tile loads
(:func:`partition_kernels.tile_gather`). Each also holds its kernel's whole
output to the plain torch version (``exact``). Times come from CUDA events
around a train of calls after a warm-up, with the wrappers' host check of
the tables made once before them; a probe needs a CUDA device and raises
on any other.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .device import resolve_device
from .partition_kernels import (N_DIGITS, TILE, group_blocks, padded_exchange,
                                padded_exchange_torch, slot_size, tile_gather,
                                tile_gather_torch)

# the bench phases' shapes (tpu_round4_bench.py:194-198, :244-249)
EXCHANGE_PAIRS = 1 << 24
EXCHANGE_BLOCK = 1 << 16     # nb = 256 blocks
EXCHANGE_MAXRUN = 1024       # runs average 256 words at 2^16 / 256 digits
EXCHANGE_SHIFT = 24          # the top byte of hi
GATHER_SOURCE = 1 << 24
GATHER_TILES = 1 << 12


def cuda_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the current CUDA device:
    one warm-up call, then CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes time the card; got device {dev}")
    return dev


def _words(rng, n, dev) -> torch.Tensor:
    return torch.from_numpy(
        rng.integers(0, 1 << 32, n, dtype=np.uint32).view(np.int32)).to(dev)


def exchange_inputs(device, seed: int) -> Tuple[torch.Tensor, ...]:
    """The probe's random (hi, lo) pairs, grouped by block, with ``maxrun``
    slack words appended: ``(hi_p, lo_p, starts, hi, lo)``."""
    n, block, maxrun = EXCHANGE_PAIRS, EXCHANGE_BLOCK, EXCHANGE_MAXRUN
    rng = np.random.default_rng(seed)
    hi, lo = _words(rng, n, device), _words(rng, n, device)
    hi_g, lo_g, starts = group_blocks(hi, lo, block=block,
                                      shift=EXCHANGE_SHIFT)
    pad = torch.zeros(maxrun, dtype=torch.int32, device=device)
    return torch.cat([hi_g, pad]), torch.cat([lo_g, pad]), starts, hi, lo


def partition_exchange_probe(device="cuda", seed: int = 0) -> Dict:
    """Group 2^24 random pairs in blocks of 2^16 by the top byte of hi and
    run the padded exchange (maxrun 1024: runs average 256 words)."""
    dev = _card(device)
    n, block, maxrun = EXCHANGE_PAIRS, EXCHANGE_BLOCK, EXCHANGE_MAXRUN
    shift = EXCHANGE_SHIFT
    hi_p, lo_p, starts, hi, lo = exchange_inputs(dev, seed)
    nb = n // block
    st = starts.cpu().numpy().astype(np.int64).reshape(nb, N_DIGITS)
    ends = np.concatenate([st[:, 1:], np.full((nb, 1), block)], axis=1)
    out = {"max_run": int((ends - st).max())}   # must be <= maxrun
    out["grouping_s"] = cuda_ms(
        lambda: group_blocks(hi, lo, block=block, shift=shift), reps=3) / 1e3

    def run(check=False):
        return padded_exchange(hi_p, lo_p, starts, block=block,
                               maxrun=maxrun, check=check)

    got = run(check=True)
    dt = cuda_ms(run, reps=5) / 1e3
    slot = slot_size(maxrun)
    out["exchange_s"] = dt
    out["exchange_written_gb_s"] = 2 * N_DIGITS * nb * slot * 4 / dt / 1e9
    out["exchange_payload_gb_s"] = 2 * n * 4 / dt / 1e9
    out["exchange_runs"] = N_DIGITS * nb
    want = padded_exchange_torch(hi_p, lo_p, starts, block=block,
                                 maxrun=maxrun)
    out["exact"] = all(torch.equal(g, w) for g, w in zip(got, want))
    return out


def gather_inputs(device, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random source of 2^24 words and 4096 random aligned tile starts
    (``tpu_round4_bench.py:245-249``)."""
    n_src, tiles = GATHER_SOURCE, GATHER_TILES
    rng = np.random.default_rng(seed)
    src = _words(rng, n_src, device)
    starts = torch.from_numpy(
        (rng.integers(0, n_src // TILE - 1, tiles) * TILE).astype(np.int32))
    return src, starts.to(device)


def element_gather_probe(device="cuda", seed: int = 0) -> Dict:
    """Random aligned 4 KB tile loads: 4096 tiles from a 2^24-word source.
    ``per_pass_s_at_2e24_elements`` prices a gather-form radix pass that
    pays one tile per gathered element."""
    dev = _card(device)
    tiles = GATHER_TILES
    src, starts = gather_inputs(dev, seed)
    got = tile_gather(src, starts)      # checks the starts once
    dt = cuda_ms(lambda: tile_gather(src, starts, check=False),
                 reps=20) / 1e3
    out = {"tiles": tiles, "ns_per_tile": dt / tiles * 1e9,
           "tile_copy_gb_s": tiles * TILE * 4 * 2 / dt / 1e9,
           "per_pass_s_at_2e24_elements": dt / tiles * (1 << 24)}
    out["exact"] = torch.equal(got, tile_gather_torch(src, starts))
    return out
