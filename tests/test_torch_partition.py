"""Parity: the port's partition-probe pieces against ``reflexiv_tpu.partition_kernels``.

The plain versions (what the wrappers run on CPU tensors) are held to the
JAX Pallas kernels in interpret mode, the JAX package's own CPU route, as
whole arrays: head slack and pad tails included. The CUDA kernels are
checked against the plain versions on the card in
``test_torch_kernels.py``. Exact: the arrays are integers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflexiv_tpu import partition_kernels as jpk
from reflexiv_tpu_torch import partition_kernels as tpk

SHIFT = 24


def _mk(n, seed, low_entropy=False):
    """(hi, lo) uint32 pairs as tests/test_partition_kernels.py makes them."""
    rng = np.random.default_rng(seed)
    if low_entropy:
        hi = (rng.integers(0, 8, n).astype(np.uint32) << SHIFT) | \
            rng.integers(0, 1 << 12, n).astype(np.uint32)
    else:
        hi = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return hi, lo


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


def _grouped(n, block, seed, low_entropy):
    hi, lo = _mk(n, seed, low_entropy)
    jhi, jlo, jst = jpk.group_blocks_xla(jnp.asarray(hi), jnp.asarray(lo),
                                         block=block, shift=SHIFT)
    thi, tlo, tst = tpk.group_blocks(_t(hi), _t(lo), block=block, shift=SHIFT)
    np.testing.assert_array_equal(_u(thi), np.asarray(jhi))
    np.testing.assert_array_equal(_u(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    return thi, tlo, tst


def _max_run(starts, nb, block):
    st = starts.numpy().reshape(nb, tpk.N_DIGITS)
    ends = np.concatenate([st[:, 1:], np.full((nb, 1), block)], axis=1)
    return int((ends - st).max())


@pytest.mark.parametrize("low_entropy,block,nb,maxrun", [
    (False, 1024, 4, None),     # random digits: short runs
    (True, 1024, 4, None),      # eight digits: long, skewed runs
    (False, 2048, 3, 1000),     # maxrun not a multiple of 1024
])
def test_padded_exchange_matches_jax_whole_arrays(low_entropy, block, nb,
                                                  maxrun):
    n = block * nb
    hi_g, lo_g, starts = _grouped(n, block, 3 + nb, low_entropy)
    maxrun = maxrun or max(_max_run(starts, nb, block), 8)
    pad = torch.zeros(maxrun, dtype=torch.int32)
    hi_p, lo_p = torch.cat([hi_g, pad]), torch.cat([lo_g, pad])
    got_hi, got_lo = tpk.padded_exchange(hi_p, lo_p, starts, block=block,
                                         maxrun=maxrun)
    want_hi, want_lo = jpk.padded_exchange(
        jnp.asarray(_u(hi_p)), jnp.asarray(_u(lo_p)),
        jnp.asarray(starts.numpy()), block=block, maxrun=maxrun,
        interpret=True)
    assert got_hi.shape == (256 * nb * tpk.slot_size(maxrun),)
    np.testing.assert_array_equal(_u(got_hi), np.asarray(want_hi))
    np.testing.assert_array_equal(_u(got_lo), np.asarray(want_lo))
    # the compacted buckets are the digit-partitioned input
    chi, clo = tpk.compact_buckets(_u(got_hi), _u(got_lo), starts.numpy(),
                                   nb=nb, block=block, maxrun=maxrun)
    whi, wlo = jpk.compact_buckets_np(want_hi, want_lo, starts.numpy(),
                                      nb=nb, block=block, maxrun=maxrun)
    np.testing.assert_array_equal(chi, whi)
    np.testing.assert_array_equal(clo, wlo)
    assert len(chi) == n


def test_padded_exchange_rejects_a_run_longer_than_maxrun():
    block, nb = 1024, 2
    hi_g, lo_g, starts = _grouped(block * nb, block, 9, True)
    maxrun = _max_run(starts, nb, block) - 1
    pad = torch.zeros(maxrun, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds maxrun"):
        tpk.padded_exchange(torch.cat([hi_g, pad]), torch.cat([lo_g, pad]),
                            starts, block=block, maxrun=maxrun)


def test_tile_gather_matches_jax():
    rng = np.random.default_rng(11)
    n_src = 16 * 1024
    src = rng.integers(0, 1 << 32, n_src, dtype=np.uint32)
    starts = (rng.integers(0, n_src // 1024, 1024) * 1024).astype(np.int32)
    want = np.asarray(jpk.tile_gather_probe(
        jnp.asarray(src), jnp.asarray(starts), interpret=True))
    got = tpk.tile_gather(_t(src), torch.from_numpy(starts))
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(
        _u(tpk.tile_gather_torch(_t(src), torch.from_numpy(starts))), want)


@pytest.mark.parametrize("bad", [512, 16 * 1024])   # misaligned; past the end
def test_tile_gather_rejects_bad_starts(bad):
    src = torch.zeros(16 * 1024, dtype=torch.int32)
    starts = torch.zeros(1024, dtype=torch.int32)
    starts[7] = bad
    with pytest.raises(ValueError, match="multiples of 1024"):
        tpk.tile_gather(src, starts)
