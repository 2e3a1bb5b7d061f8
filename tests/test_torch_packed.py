"""Parity: one packed extension round, the census and the pool operations
of the port against the JAX package's CPU forms (lexsort + index round,
non-scatter-free census), row for row. Exact: integers."""
import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import oracle
from reflexiv_tpu import assembler as jasm
from reflexiv_tpu import count as jcount
from reflexiv_tpu import packed as jpk
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu.params import Params
from reflexiv_tpu.records import next_pow2
from reflexiv_tpu_torch import packed as tpk

K = 21


def _jax_state(rounds):
    """A JAX PackedRecords pool after ``rounds`` rounds of a small
    synthetic with errors (so forks and tips are present)."""
    rng = random.Random(11)
    genome = "".join(rng.choice("ACGT") for _ in range(700))
    reads = []
    for _ in range(700 * 25 // 70):
        s = rng.randrange(len(genome) - 70)
        r = "".join(c if rng.random() > 0.01 else rng.choice("ACGT")
                    for c in genome[s:s + 70])
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    limbs, counts = jcount.count_kmers(mat, lens, k=K, min_cov=2)
    recs, _ = jasm.initial_records_from_counts(
        limbs, counts, Params(k=K, min_kmer_coverage=2))
    p = jpk.from_records(recs)
    need = 2 * int(jnp.max(jnp.where(p.live, p.length, 0))) - (K - 1)
    for it in range(1, rounds + 1):
        if need > p.base_capacity:
            p = jpk.grow_packed(p, next_pow2(need))
        p, _n, need = jpk._extension_round_packed(
            p, jnp.uint32(100 + it), k=K, variadic=False, partner_fill=False)
        need = int(need)
    return p


def _to_torch(p):
    return tpk.PackedRecords(
        torch.from_numpy(np.asarray(p.seq).astype(np.int64)),
        *(torch.from_numpy(np.array(x)) for x in p[1:]))


def _assert_equal(tp, jp):
    np.testing.assert_array_equal(tp.seq.numpy(),
                                  np.asarray(jp.seq).astype(np.int64))
    for name in ("length", "left", "right", "live"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def states():
    return {r: _jax_state(r) for r in (0, 3)}


@pytest.mark.parametrize("rounds", [0, 3])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_round_matches_jax_row_for_row(states, rounds, seed):
    jp = states[rounds]
    tp = _to_torch(jp)
    jout, jn, jneed = jpk._extension_round_packed(
        jp, jnp.uint32(seed), k=K, variadic=False, partner_fill=False)
    tout, tn, tneed = tpk.extension_round_packed(tp, seed, k=K)
    _assert_equal(tout, jout)
    assert int(tn) == int(jn) and int(tneed) == int(jneed)
    assert int(tn) < int(tp.live.sum())      # the round merged something
    np.testing.assert_array_equal(
        tpk.finished_mask_packed(tout, K).numpy(),
        np.asarray(jpk._finished_mask_packed(jout, K, scatter_free=False)))


@pytest.mark.parametrize("rounds", [0, 3])
def test_markers_and_keys_match_jax(states, rounds):
    jp = states[rounds]
    tp = _to_torch(jp)
    jm = np.asarray(jpk.draw_markers_packed(jp, jnp.uint32(7)))
    tm = tpk.draw_markers_packed(tp, 7)
    np.testing.assert_array_equal(tm.numpy(), jm)
    jkeys = np.asarray(jpk.derive_keys_packed(jp, jnp.asarray(jm), K))
    tkeys = tpk.derive_keys_packed(tp, tm, K)
    # left-aligned (hi, lo) limbs -> the port's right-aligned 40-bit key
    live = np.asarray(jp.live)
    want = ((jkeys[:, 0].astype(np.int64) << 8)
            | (jkeys[:, 1].astype(np.int64) >> 24))
    np.testing.assert_array_equal(tkeys.numpy()[live], want[live])
    assert (tkeys.numpy()[~live] == 1 << 60).all()


@pytest.mark.parametrize("width", [5, 16, 17, 30, 33])
def test_extract_window_matches_jax(states, width):
    jp = states[3]
    tp = _to_torch(jp)
    start = np.maximum(np.asarray(jp.length) - width, 0).astype(np.int32)
    want = np.asarray(jpk.extract_window(jp.seq, jnp.asarray(start), width))
    got = tpk.extract_window(tp.seq, torch.from_numpy(start), width)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_pool_operations_match_jax(states):
    jp = states[3]
    tp = _to_torch(jp)
    # park every third live row: parking takes any host mask
    fin = np.asarray(jp.live) & (np.arange(jp.capacity) % 3 == 0)
    jparked, tparked = [], []
    jp2 = jpk.park_finished_rows(jp, fin, jparked)
    tp2 = tpk.park_finished_rows(tp, torch.from_numpy(fin), tparked)
    _assert_equal(tp2, jp2)
    jc = jpk.compact_packed(jp2, 64)
    tc = tpk.compact_packed(tp2, 64)
    _assert_equal(tc, jc)
    jg = jpk.grow_packed(jc, 300)
    tg = tpk.grow_packed(tc, 300)
    _assert_equal(tg, jg)
    _assert_equal(tpk.merge_parked_packed(tg, tparked),
                  jpk.merge_parked_packed(jg, jparked))
    jr = jpk.to_records(jg)
    tr = tpk.to_records(tg)
    for got, want in zip(tr, jr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
