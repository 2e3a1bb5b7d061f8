"""Parity: the port's counting sort against the JAX Pallas bitonic sort.

The plain version (what the wrapper runs on CPU tensors) is held to
``sort_pairs_padded`` in interpret mode on one 65,536-key block with heavy
duplicates and a sentinel tail; exactly equal up to the JAX padding. The
CUDA radix kernel is checked against it on the card in
``test_torch_kernels.py``."""
import torch_threads  # noqa: F401
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from reflexiv_tpu.sort_kernels import BLOCK, sort_pairs_padded
from reflexiv_tpu_torch.bitpack import keys_from_limbs, limbs_from_keys
from reflexiv_tpu_torch.kernels import extract as ext
from reflexiv_tpu_torch.kernels import radix_sort


def _counting_keys(k, n, seed):
    """Keys as the counting pass makes them: few distinct values, and
    invalid windows as the sentinel at random places."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << (2 * k), 97, dtype=np.int64)
    keys = pool[rng.integers(0, len(pool), n)]
    keys[rng.random(n) < 0.3] = ext.sentinel(k)
    return torch.from_numpy(keys)


@pytest.mark.parametrize("k", [21, 31])
def test_plain_sort_matches_pallas_sort_pairs_padded(k):
    keys = _counting_keys(k, BLOCK - 1000, seed=k)
    limbs = limbs_from_keys(keys, k).numpy().astype(np.uint32)
    shi, slo = sort_pairs_padded(jnp.asarray(limbs[:, 0]),
                                 jnp.asarray(limbs[:, 1]), interpret=True)
    want = np.stack([np.asarray(shi), np.asarray(slo)], axis=1)
    assert want.shape[0] == BLOCK            # JAX pads to the block
    got = radix_sort.sort_keys(keys, bits=2 * k)
    np.testing.assert_array_equal(
        limbs_from_keys(got, k).numpy().astype(np.uint32),
        want[: keys.numel()])
    assert (want[keys.numel():] == 0xFFFFFFFF).all()
    assert torch.equal(keys_from_limbs(want[: keys.numel()], k), got)
    n_sent = int((keys == ext.sentinel(k)).sum())
    assert (got[-n_sent:] == ext.sentinel(k)).all()
