"""Parity: one mixed-k extension round of the port's ``meta`` against
``reflexiv_tpu``'s.

The summary join (``packed_dyn.pdyn_round_indexed``) is compared per row
id on inputs where no two rows share (group key, marker): there the join
does not depend on the order of ties, which the JAX ``lax.sort`` leaves
open. The host round (``dynamic._pdyn_round_indexed_host``) is compared as
a multiset of records on a duplicate-heavy input, with the ragged pool's
dense width shrunk on both packages so the per-row overflow splice runs
too. Exact: everything is integer."""
import torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from reflexiv_tpu import dynamic as jdyn
from reflexiv_tpu import join_core as jjoin
from reflexiv_tpu import packed_dyn as jpd
from reflexiv_tpu.packed import concat as jconcat
from reflexiv_tpu.packed import pack_seq_matrix as jpack
from reflexiv_tpu_torch import dyn_pool, meta
from reflexiv_tpu_torch import packed_dyn as tpd
from reflexiv_tpu_torch.join_core import merge_gate


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("with_extra", [False, True])
def test_merge_gate_matches_jax(with_extra):
    rng = np.random.default_rng(2)
    n = 4000
    cols = [rng.integers(-60, 60, n).astype(np.int32) for _ in range(4)]
    f_ext, r_ext = (rng.integers(1, 40, n).astype(np.int32)
                    for _ in range(2))
    extra = rng.integers(0, 30, n).astype(np.int32) if with_extra else None
    want = jjoin.merge_gate(
        *(jnp.asarray(c) for c in cols), jnp.asarray(f_ext),
        jnp.asarray(r_ext),
        extra=None if extra is None else jnp.asarray(extra))
    got = merge_gate(*(_t(c) for c in cols), _t(f_ext), _t(r_ext),
                     extra=None if extra is None else _t(extra))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got.merge.sum()) < n


def _chain_rows(rng, klist, n_rows, genome_bp):
    """Pieces of a random genome, each one k-class long plus an extension,
    consecutive pieces overlapping by the earlier one's sub-k-mer, so that
    forward heads meet reflected tails; some rows reverse-complemented."""
    g = rng.integers(0, 4, genome_bp).astype(np.uint8)
    rows, subks = [], []
    at = 0
    while len(rows) < n_rows:
        k = int(rng.choice(klist))
        n = k + int(rng.integers(0, 9))
        if at + n > genome_bp:
            at = int(rng.integers(0, 50))
        piece = g[at:at + n]
        if rng.random() < 0.3:
            piece = (3 - piece[::-1]).astype(np.uint8)
        rows.append(piece)
        subks.append(k - 1)
        at += n - (k - 1)
    width = max(len(r) for r in rows)
    seq = np.zeros((n_rows, width), np.uint8)
    for i, r in enumerate(rows):
        seq[i, :len(r)] = r
    length = np.asarray([len(r) for r in rows], np.int32)
    return seq, length, np.asarray(subks, np.int32)


def _summaries(seq, length, subk, max_sub):
    packed = dyn_pool.pack_seq_matrix_np(seq)
    return dyn_pool.host_summaries((packed, length, subk), max_sub)


@pytest.mark.parametrize("unique_only", [False, True])
@pytest.mark.parametrize("klist", [(5, 7, 9), (21, 31, 41), (35, 45, 55)])
def test_summary_join_matches_jax_per_row(klist, unique_only):
    """(35, 45, 55): a 34-base group key, sorted limb by limb."""
    rng = np.random.default_rng(sum(klist) + unique_only)
    kmin, max_sub = min(klist), max(klist) - 1
    seq, length, subk = _chain_rows(rng, klist, 600, 4000)
    left = rng.integers(-5, 3, len(length)).astype(np.int32)
    right = rng.integers(-5, 3, len(length)).astype(np.int32)
    seed = 17
    head, tail, h16, t16 = _summaries(seq, length, subk, max_sub)
    # keep the rows whose (group key, marker) no earlier row has
    marker = tpd.draw_markers(_t(h16), _t(t16), _t(length), seed).numpy()
    Wp = tpd.limbs_for(kmin - 1)
    keys = np.where((marker == 1)[:, None], head[:, :Wp], tail[:, :Wp])
    rem = kmin - 1 - 16 * (Wp - 1)
    keys[:, -1] &= np.uint32((0xFFFFFFFF << (32 - 2 * rem)) & 0xFFFFFFFF)
    seen, keep = set(), []
    for i in range(len(length)):
        tag = (keys[i].tobytes(), int(marker[i]))
        if tag not in seen:
            seen.add(tag)
            keep.append(i)
    keep = np.asarray(keep)
    cols = [a[keep] for a in (head, tail, h16, t16, length, subk, left,
                              right)]
    n = len(keep)
    soid, action, partner, nl, nr = (np.asarray(x) for x in
                                     jpd.pdyn_round_indexed(
        *(jnp.asarray(c) for c in cols), jnp.ones(n, bool),
        jnp.arange(n, dtype=jnp.int32), jnp.uint32(seed), kmin=kmin,
        max_sub=max_sub, unique_only=unique_only))
    fw = action == 1
    order = np.argsort(soid[fw])
    want = (soid[fw][order], partner[fw][order], nl[fw][order],
            nr[fw][order])
    got = tpd.pdyn_round_indexed(*(_t(c) for c in cols), seed, kmin=kmin,
                                 max_sub=max_sub, unique_only=unique_only)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert sorted(soid[action == 2]) == sorted(got[1].tolist())
    assert len(got[0]) > 5


def _dup_heavy_pool(klist):
    """Overlapping genome pieces, half of them overwritten by copies of
    others (cf. tests/test_dynamic.py::test_indexed_round_matches
    _monolithic): groups with many identical rows."""
    rng = np.random.default_rng(11)
    n = 384
    seqb, length, subk = _chain_rows(rng, klist, n, 3000)
    dup = rng.integers(0, n, size=n // 2)
    seqb[dup // 2], length[dup // 2] = seqb[dup], length[dup]
    subk[dup // 2] = subk[dup]
    hp = (dyn_pool.pack_seq_matrix_np(seqb), length, subk,
          np.full(n, -1, np.int32), np.full(n, -1, np.int32))
    return hp, int(length.max()) * 2


def _multiset(groups):
    out = []
    for sq, ls, sk, lf, rt in groups:
        out += [(int(ls[i]), int(sk[i]), int(lf[i]), int(rt[i]),
                 sq[i].tobytes().rstrip(b"\0")) for i in range(len(ls))]
    return sorted(out)


@pytest.mark.parametrize("klist,unique_only", [
    ((5, 7, 9), False), ((21, 31, 41), False), ((5, 7, 9), True),
])
def test_host_round_matches_jax_as_multiset(klist, unique_only, monkeypatch):
    kmin, max_sub = min(klist), max(klist) - 1
    hp, need = _dup_heavy_pool(klist)
    monkeypatch.setattr(jdyn._RaggedPool, "W_DENSE", 1)
    monkeypatch.setattr(dyn_pool.RaggedPool, "W_DENSE", 1)
    monkeypatch.setenv("REFLEXIV_BUCKET_CAP", "64")
    jrp = jdyn._RaggedPool.from_dense(hp)
    trp = dyn_pool.RaggedPool.from_dense(hp)
    jsum = jdyn._summaries_ragged(jrp, max_sub)
    tsum = dyn_pool.summaries_ragged(trp, max_sub)
    for a, b in zip(tsum, jsum):
        np.testing.assert_array_equal(a, b)
    seed = 29
    jrp2, jsum2, jn, jneed = jdyn._pdyn_round_indexed_host(
        jrp, jsum, seed, kmin=kmin, max_sub=max_sub,
        unique_only=unique_only, need=need)
    trp2, tsum2, tn, tneed = meta.pdyn_round_indexed_host(
        trp, tsum, seed, kmin=kmin, max_sub=max_sub,
        unique_only=unique_only, need=need, device="cpu")
    assert (tn, tneed) == (jn, jneed)
    assert tn < len(hp[1])
    assert trp2.over   # merges past 16 bases took the per-row splice
    assert _multiset(trp2.to_groups()) == _multiset(jrp2.to_groups())
    # the maintained summaries equal fresh ones, and the census from them
    # equals the JAX census on the same rows
    for a, b in zip(tsum2, dyn_pool.summaries_ragged(trp2, max_sub)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tpd.finished_mask(_t(tsum2[0]), _t(tsum2[1]), _t(trp2.subk),
                          max_sub).numpy(),
        jdyn._finished_mask_from_summ(tsum2, trp2.subk, max_sub))


@pytest.mark.parametrize("klist", [(5, 7, 9), (21, 31, 41), (35, 45, 55)])
def test_census_matches_jax(klist):
    """Chained rows (heads meet tails), a fifth of them with random bases:
    both finished and unfinished rows, interval ends tied between rows."""
    rng = np.random.default_rng(len(klist) + sum(klist))
    max_sub = max(klist) - 1
    seq, length, subk = _chain_rows(rng, klist, 2000, 6000)
    noise = rng.random(len(length)) < 0.2
    seq[noise] = rng.integers(0, 4, seq[noise].shape).astype(np.uint8)
    seq[np.arange(seq.shape[1])[None, :] >= length[:, None]] = 0
    head, tail, _h16, _t16 = _summaries(seq, length, subk, max_sub)
    want = jdyn._finished_mask_from_summ((head, tail), subk, max_sub)
    got = tpd.finished_mask(_t(head), _t(tail), _t(subk), max_sub).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)


def test_ragged_pool_matches_jax(monkeypatch):
    """from_dense, to_groups, from_groups and select give the JAX pool's
    arrays, overflow rows included."""
    hp, _need = _dup_heavy_pool((5, 7, 9, 40))
    monkeypatch.setattr(jdyn._RaggedPool, "W_DENSE", 2)
    monkeypatch.setattr(dyn_pool.RaggedPool, "W_DENSE", 2)
    jrp, trp = jdyn._RaggedPool.from_dense(hp), \
        dyn_pool.RaggedPool.from_dense(hp)
    idx = np.arange(0, len(hp[1]), 3)
    for j, t in ((jrp, trp), (jrp.select(idx), trp.select(idx)),
                 (jdyn._RaggedPool.from_groups(jrp.to_groups()),
                  dyn_pool.RaggedPool.from_groups(trp.to_groups()))):
        assert sorted(j.over) == sorted(t.over)
        for i in j.over:
            np.testing.assert_array_equal(j.over[i], t.over[i])
        for a, b in zip(t.to_groups(), j.to_groups()):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    dense = dyn_pool.groups_to_dense(trp.to_groups())
    for x, y in zip(dense, jdyn._groups_to_dense(jrp.to_groups())):
        np.testing.assert_array_equal(x, y)


def test_host_splices_match_jax():
    """The numpy splices equal the JAX device concat (and each other)."""
    rng = np.random.default_rng(3)
    M, cap = 64, 96
    la = rng.integers(5, cap - 1, M).astype(np.int32)
    lb = rng.integers(5, cap - 1, M).astype(np.int32)
    skip = np.minimum(rng.integers(0, 30, M), lb - 1).astype(np.int32)

    def mk(lens):
        b = np.zeros((M, cap), np.uint8)
        for i in range(M):
            b[i, :lens[i]] = rng.integers(0, 4, lens[i])
        return np.asarray(jpack(jnp.asarray(b)))

    a_, b_ = mk(la), mk(lb)
    out_limbs = dyn_pool.limbs_for(int((la + lb - skip).max()))
    want_seq, want_len = jconcat(
        jnp.asarray(a_), jnp.asarray(la), jnp.asarray(b_), jnp.asarray(lb),
        jnp.asarray(skip), out_limbs)
    got_seq, got_len = dyn_pool.host_concat_packed(a_, la, b_, lb, skip,
                                                   out_limbs)
    np.testing.assert_array_equal(got_seq, np.asarray(want_seq))
    np.testing.assert_array_equal(got_len, np.asarray(want_len))
    for i in range(M):
        row, tot = dyn_pool.host_concat_row(a_[i], int(la[i]), b_[i],
                                            int(lb[i]), int(skip[i]))
        assert tot == got_len[i]
        np.testing.assert_array_equal(row, got_seq[i, :len(row)])
