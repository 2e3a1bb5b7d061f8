"""Parity: the port's canonical k-mer extraction against the JAX package's.

The plain torch version (what the wrapper runs on CPU tensors) is held to
the Pallas kernel in interpret mode, the JAX package's own CPU route, as a
multiset of valid keys, and to the XLA extraction for the clips. Exact: the
keys are integers. The CUDA kernel itself is checked against the plain
version on the card in ``test_torch_kernels.py``."""
import torch_threads  # noqa: F401
import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from reflexiv_tpu.count import extract_canonical_kmers
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu.pallas_kernels import extract_canonical_kmers_pallas
from reflexiv_tpu_torch.bitpack import limbs_from_keys
from reflexiv_tpu_torch.kernels import extract as ext


def _reads(k, seed, lengths):
    rng = random.Random(seed)
    reads = ["".join(rng.choice("ACGT") for _ in range(rng.choice(lengths)))
             for _ in range(60)]
    reads += ["".join(rng.choice("ACGT") for _ in range(n)) for n in lengths]
    return reads_to_matrix([r.encode() for r in reads])


def _sorted_rows(limbs):
    limbs = np.asarray(limbs).astype(np.uint64)
    key = np.zeros(len(limbs), np.uint64)
    for i in range(limbs.shape[1]):
        key = (key << np.uint64(32)) | limbs[:, i]
    return np.sort(key)


def _port_valid(mat, lens, k, **clips):
    keys = ext.extract_canonical_keys(
        torch.from_numpy(mat), torch.from_numpy(lens), k=k, **clips)
    return keys[keys != ext.sentinel(k)], keys


@pytest.mark.parametrize("k", [17, 21, 31])
def test_plain_extraction_matches_pallas_interpret(k):
    mat, lens = _reads(k, k, [k - 2, k, k + 1, k + 3, 50])
    limbs, valid = extract_canonical_kmers_pallas(
        jnp.asarray(mat), jnp.asarray(lens), k=k, interpret=True)
    want = _sorted_rows(np.asarray(limbs)[np.asarray(valid)])
    got, _ = _port_valid(mat, lens, k)
    np.testing.assert_array_equal(
        _sorted_rows(limbs_from_keys(got, k).numpy()), want)


@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("front_clip,end_clip", [(3, 2), (0, 5), (4, 0)])
def test_plain_extraction_clips_match_xla(k, front_clip, end_clip):
    mat, lens = _reads(k, 100 + k, [k - 2, k + 1, k + 4, k + 8, 50])
    limbs, valid = extract_canonical_kmers(
        jnp.asarray(mat), jnp.asarray(lens), k=k,
        front_clip=front_clip, end_clip=end_clip)
    got, keys = _port_valid(mat, lens, k, front_clip=front_clip,
                            end_clip=end_clip)
    # same window order and the same validity mask, row for row
    np.testing.assert_array_equal((keys != ext.sentinel(k)).numpy(),
                                  np.asarray(valid))
    np.testing.assert_array_equal(
        limbs_from_keys(got, k).numpy().astype(np.uint32),
        np.asarray(limbs)[np.asarray(valid)])


def test_short_reads_yield_no_kmers():
    """len - k > 1 is the read gate: reads of length k and k+1 give none."""
    k = 21
    mat, lens = _reads(k, 5, [k, k + 1])
    mat, lens = mat[lens <= k + 1], lens[lens <= k + 1]
    got, _ = _port_valid(mat, lens, k)
    assert got.numel() == 0
