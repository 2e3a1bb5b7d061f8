"""Partition-exchange primitives: CUDA kernel wrappers + plain torch versions.

Port of the TPU kernels ``reflexiv_tpu/partition_kernels.py:67``
``_exchange_kernel_factory`` (via ``padded_exchange``) and ``:260``
``_tile_gather_kernel_factory`` (via ``tile_gather_probe``); the kernels
are ``reflexiv_tpu_torch/csrc/partition.cu``. Both only copy 32-bit words,
so the arrays are ``torch.int32`` tensors holding the uint32 bit patterns
of the JAX arrays (``.numpy().view(np.uint32)`` gives them back).

The wrappers check on the host what the TPU kernels assumed silently: a
run longer than ``maxrun`` (which the TPU copy truncates) and a tile start
that is not a multiple of 1024 or runs past the source (which gives wrong
data on the TPU) raise ``ValueError``. The check copies the table to the
host; ``check=False`` skips it for a table already checked, as the
probes' timed repeats do.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

N_DIGITS = 256
TILE = 1024   # copy alignment: the TPU's 1-D tiling, kept as the layout

EXCHANGE_LAUNCHES = 0   # kernel launches by padded_exchange
GATHER_LAUNCHES = 0     # kernel launches by tile_gather


def slot_size(maxrun: int) -> int:
    """Padded bucket-slot stride: a copy starts at its run's source
    position rounded down to ``TILE`` (up to ``TILE - 1`` head words) and
    covers ``maxrun`` payload words."""
    return maxrun + TILE


def _check_words(*arrays) -> None:
    dev = arrays[0].device
    for a in arrays:
        if a.dtype != torch.int32 or a.dim() != 1:
            raise TypeError(f"need 1-D int32 tensors, got {a.dtype} "
                            f"{tuple(a.shape)}")
        if a.device != dev:
            raise ValueError("all tensors must be on one device")


def _exchange_geometry(hi_g, lo_g, starts, block, maxrun, check=True):
    """(nb, slot) after checking shapes and, with ``check``, that every run
    lies in its block with a length in [0, maxrun]."""
    _check_words(hi_g, lo_g, starts)
    if block < 1 or maxrun < 1:
        raise ValueError(f"block={block} and maxrun={maxrun} must be >= 1")
    total = hi_g.shape[0] - maxrun
    if total < 0 or total % block or lo_g.shape != hi_g.shape:
        raise ValueError(f"hi/lo of {hi_g.shape[0]}/{lo_g.shape[0]} words are "
                         f"not nb * {block} + {maxrun}")
    nb = total // block
    if starts.shape != (nb * N_DIGITS,):
        raise ValueError(f"starts has {starts.shape[0]} entries, not "
                         f"{nb} * {N_DIGITS}")
    if not check:
        return nb, slot_size(maxrun)
    st = starts.cpu().numpy().astype(np.int64).reshape(nb, N_DIGITS)
    ends = np.concatenate([st[:, 1:], np.full((nb, 1), block)], axis=1)
    lens = ends - st
    if nb and (st.min() < 0 or st.max() > block or lens.min() < 0):
        raise ValueError("run starts must be monotone within [0, block] "
                         "in every block")
    if nb and lens.max() > maxrun:
        raise ValueError(f"a run of {int(lens.max())} words exceeds "
                         f"maxrun={maxrun} (the TPU kernel truncates it)")
    return nb, slot_size(maxrun)


def _with_slack(x: torch.Tensor) -> torch.Tensor:
    """Append the ``TILE`` zeros of align-down slack (partition_kernels.py
    :213-214): a copy may start up to ``TILE - 1`` words before its run."""
    return torch.cat([x, x.new_zeros(TILE)])


def padded_exchange_torch(hi_g, lo_g, starts, *, block: int, maxrun: int):
    """Plain version of :func:`padded_exchange`: one gather of every slot's
    source words (the table is the caller's to check, as the wrapper
    does)."""
    nb, slot = _exchange_geometry(hi_g, lo_g, starts, block, maxrun,
                                  check=False)
    dev = hi_g.device
    b = torch.arange(nb, device=dev).repeat_interleave(N_DIGITS)
    src = b * block + starts.to(torch.int64)
    src_t = (src // TILE) * TILE                       # (nb * 256,), b-major
    d_major = src_t.reshape(nb, N_DIGITS).t().reshape(-1)   # slot order
    idx = (d_major[:, None] + torch.arange(slot, device=dev)).reshape(-1)
    return _with_slack(hi_g)[idx], _with_slack(lo_g)[idx]


def padded_exchange(hi_g, lo_g, starts, *, block: int, maxrun: int,
                    check: bool = True):
    """Padded run-copy partition exchange (``partition_kernels.padded_exchange``).

    ``hi_g``/``lo_g``: ``(nb * block + maxrun,)`` int32, block-grouped, with
    ``maxrun`` slack words appended; ``starts``: ``(nb * 256,)`` int32, run
    (b, d)'s start within block b. Returns ``(out_hi, out_lo)``, each
    ``(256 * nb * slot,)`` int32 with ``slot = maxrun + 1024``; run (b, d)'s
    payload lands at ``(d * nb + b) * slot + (b * block + starts[b, d]) %
    1024``.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`padded_exchange_torch`."""
    global EXCHANGE_LAUNCHES
    nb, slot = _exchange_geometry(hi_g, lo_g, starts, block, maxrun, check)
    if hi_g.device.type == "cpu":
        return padded_exchange_torch(hi_g, lo_g, starts, block=block,
                                     maxrun=maxrun)
    if hi_g.device.type != "cuda":
        raise ValueError(f"tensors on {hi_g.device}: need CUDA or CPU")
    hi_s, lo_s = _with_slack(hi_g.contiguous()), _with_slack(lo_g.contiguous())
    starts = starts.contiguous()
    out_hi = torch.empty(N_DIGITS * nb * slot, dtype=torch.int32,
                         device=hi_g.device)
    out_lo = torch.empty_like(out_hi)
    build.launch("rfx_padded_exchange", hi_g.device, hi_s.data_ptr(),
                 lo_s.data_ptr(), starts.data_ptr(), out_hi.data_ptr(),
                 out_lo.data_ptr(), nb, block, slot)
    EXCHANGE_LAUNCHES += 1
    return out_hi, out_lo


def _check_tiles(src, tile_starts, check=True) -> None:
    _check_words(src, tile_starts)
    if tile_starts.shape[0] % TILE:
        raise ValueError(f"{tile_starts.shape[0]} tile starts: need a "
                         f"multiple of {TILE}")
    if not check:
        return
    st = tile_starts.cpu().numpy().astype(np.int64)
    if st.size and ((st % TILE).any() or st.min() < 0
                    or st.max() + TILE > src.shape[0]):
        raise ValueError(f"tile starts must be multiples of {TILE} with "
                         f"start + {TILE} <= {src.shape[0]} (a misaligned "
                         "start gives wrong data on the TPU)")


def tile_gather_torch(src: torch.Tensor, tile_starts: torch.Tensor):
    """Plain version of :func:`tile_gather`: one gather (the starts are the
    caller's to check, as the wrapper does)."""
    _check_tiles(src, tile_starts, check=False)
    idx = tile_starts.to(torch.int64)[:, None] + torch.arange(
        TILE, device=src.device)
    return src[idx.reshape(-1)]


def tile_gather(src: torch.Tensor, tile_starts: torch.Tensor, *,
                check: bool = True):
    """``out[t*1024:(t+1)*1024] = src[tile_starts[t] : +1024]``
    (``partition_kernels.tile_gather_probe``): ``src`` int32 words,
    ``tile_starts`` ``(M,)`` int32 with M a multiple of 1024 and every start
    a multiple of 1024 -> ``(M * 1024,)`` int32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`tile_gather_torch`."""
    global GATHER_LAUNCHES
    _check_tiles(src, tile_starts, check)
    dev = src.device
    if dev.type == "cpu":
        return tile_gather_torch(src, tile_starts)
    if dev.type != "cuda":
        raise ValueError(f"tensors on {dev}: need CUDA or CPU")
    if not (src.is_contiguous() and tile_starts.is_contiguous()):
        raise ValueError("src and tile_starts must be contiguous")
    if src.data_ptr() % 16:
        raise ValueError("src must start 16-byte aligned (16-byte copies)")
    n_tiles = tile_starts.shape[0]
    out = torch.empty(n_tiles * TILE, dtype=torch.int32, device=dev)
    build.launch("rfx_tile_gather", dev, src.data_ptr(),
                 tile_starts.data_ptr(), out.data_ptr(), n_tiles)
    GATHER_LAUNCHES += 1
    return out
