"""Parity: the port's fork-filtered record set against the JAX package's
``build_initial_records`` (row for row, live mask included) and the scalar
oracle ``tests/oracle.py`` (as a set). Exact: integers."""
import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import oracle
from reflexiv_tpu.graph import build_initial_records as jax_build
from reflexiv_tpu_torch.bitpack import (decode_to_str, encode_ascii,
                                        limbs_from_keys, pack_bases)
from reflexiv_tpu_torch.graph import build_initial_records


def _tables(counted, k):
    kmers = sorted(counted)
    codes = np.stack([encode_ascii(np.frombuffer(s.encode(), np.uint8))
                      for s in kmers])
    keys = pack_bases(torch.from_numpy(codes), k)
    counts = torch.tensor([counted[s] for s in kmers], dtype=torch.int32)
    return keys, counts


def _live_set(recs):
    out = set()
    for i in torch.nonzero(recs.live).squeeze(1).tolist():
        n = int(recs.length[i])
        out.add((decode_to_str(recs.seq[i, :n].numpy()),
                 int(recs.left[i]), int(recs.right[i])))
    return out


def _check(reads, k, min_cov, min_error, bubble=True):
    counted = oracle.count_kmers(reads, k, min_cov=min_cov)
    keys, counts = _tables(counted, k)
    recs = build_initial_records(keys, counts, k=k, min_error=min_error,
                                 bubble=bubble)
    jrecs, _marker = jax_build(
        jnp.asarray(limbs_from_keys(keys, k).numpy().astype(np.uint32)),
        jnp.asarray(counts.numpy()), k=k, min_error=min_error, bubble=bubble)
    for got, want in zip(recs, jrecs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if bubble:
        want = {(r.seq, r.left, r.right)
                for r in oracle.build_records(reads, k, min_cov, min_error)}
        assert _live_set(recs) == want
    return recs


@pytest.mark.parametrize("k", [17, 21, 31])
def test_linear_genome(k):
    rng = random.Random(3 + k)
    genome = "".join(rng.choice("ACGT") for _ in range(90))
    recs = _check([genome, genome], k=k, min_cov=1, min_error=8)
    assert int(recs.live.sum()) == 2 * (len(genome) - k + 1)


@pytest.mark.parametrize("weights,killed", [
    ((5, 5), False),     # equal strong branches -> blocked fork
    ((10, 1), True),     # weak branch, cover <= minError and strong >= 2x
    ((25, 9), False),    # weak branch above minError -> blocked
])
def test_fork_blocking_and_error_kill(weights, killed):
    rng = random.Random(5)
    core = "".join(rng.choice("ACGT") for _ in range(60))
    alt1 = core + "A" + "".join(rng.choice("ACGT") for _ in range(30))
    alt2 = core + "C" + "".join(rng.choice("ACGT") for _ in range(30))
    recs = _check([alt1] * weights[0] + [alt2] * weights[1],
                  k=21, min_cov=1, min_error=8)
    # one of the two k-mers leaving the fork wins; its right end is
    # blocked unless the weak branch was killed as an error
    fork_kmers = {core[-20:] + "A", core[-20:] + "C"}
    rows = [(s, l, r) for s, l, r in _live_set(recs) if s in fork_kmers]
    assert len(rows) == 1
    assert (rows[0][2] < 0) == killed


def test_bubble_off_keeps_every_strand():
    rng = random.Random(8)
    core = "".join(rng.choice("ACGT") for _ in range(50))
    reads = [core + "A" + core[:20], core + "C" + core[5:25]] * 3
    recs = _check(reads, k=21, min_cov=1, min_error=8, bubble=False)
    assert bool(recs.live.all())
    assert torch.equal(recs.left, recs.right)
