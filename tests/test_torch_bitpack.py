"""Parity: the torch port's int64 bitpack against the JAX limb bitpack.

Everything is integer, so every comparison is exact."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from reflexiv_tpu import bitpack as jbp
from reflexiv_tpu_torch import bitpack as tbp


def _codes(k, n=300, seed=0):
    rng = np.random.default_rng(seed + k)
    codes = rng.integers(0, 4, (n, k), dtype=np.uint8)
    codes[0] = 0            # poly-A
    codes[1] = 3            # poly-T
    return codes


@pytest.mark.parametrize("k", [15, 21, 31])
def test_pack_unpack_and_converters_match_jax(k):
    codes = _codes(k)
    limbs = np.asarray(jbp.pack_bases(jnp.asarray(codes), k))
    keys = tbp.pack_bases(torch.from_numpy(codes), k)
    got = tbp.limbs_from_keys(keys, k).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, limbs)
    assert torch.equal(tbp.keys_from_limbs(limbs, k), keys)
    np.testing.assert_array_equal(tbp.unpack_bases(keys, k).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(jbp.unpack_bases(jnp.asarray(limbs), k)),
        tbp.unpack_bases(keys, k).numpy())


@pytest.mark.parametrize("k", [15, 21, 31])
def test_revcomp_and_canonical_match_jax(k):
    codes = _codes(k, seed=1)
    limbs = jnp.asarray(np.asarray(jbp.pack_bases(jnp.asarray(codes), k)))
    rc_limbs = jbp.revcomp_packed(limbs, k)
    canon = np.asarray(jbp.canonical_packed(limbs, rc_limbs))
    keys = tbp.pack_bases(torch.from_numpy(codes), k)
    rc = tbp.revcomp_keys(keys, k)
    np.testing.assert_array_equal(
        tbp.limbs_from_keys(rc, k).numpy().astype(np.uint32),
        np.asarray(rc_limbs))
    np.testing.assert_array_equal(
        tbp.limbs_from_keys(tbp.canonical_keys(keys, rc), k).numpy()
        .astype(np.uint32), canon)


def test_mix32_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jbp.mix32(jnp.asarray(x)))
    got = tbp.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF


@pytest.mark.parametrize("k", [15, 21, 31])
def test_keys_from_limbs_inverts_limbs_from_keys(k):
    rng = np.random.default_rng(k)
    keys = torch.from_numpy(
        rng.integers(0, 1 << (2 * k), 1000, dtype=np.int64))
    assert torch.equal(
        tbp.keys_from_limbs(tbp.limbs_from_keys(keys, k), k), keys)


def test_k_out_of_range_raises():
    with pytest.raises(ValueError):
        tbp.pack_bases(torch.zeros((2, 100), dtype=torch.uint8), 100)
    with pytest.raises(ValueError):      # the run path keeps one word
        tbp.check_k(32, tbp.RUN_MAX_K)
