"""Parity of the port's ``meta`` on a mesh with the JAX package's: the JAX
side on the 8 virtual CPU devices of ``tests/conftest.py``, the port on
``make_mesh(["cpu"] * 8)``. Exact throughout: the dense round and each
shard's rows in order, the census, parking, the mesh loop's pool (its
parking branch, the one-key skew retry, checkpoints resumed across the
packages), stage 00's records and the sharded mercy table as a set.
``test_torch_parallel_meta_stages.py`` holds the other half (whole
assemblies, dense fixing, the ``dryrun_multichip`` meta chain, the CLI)
and shares this file's helpers and ``jx`` fixture.

The JAX imports live in the ``jx`` fixture, so the ``cuda`` test imports
no jax and runs on a card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_parallel_meta.py``."""
import torch_threads  # noqa: F401
import dataclasses
import logging
import random
import re
import types

import numpy as np
import pytest
import torch

import oracle
from reflexiv_tpu_torch import meta, parallel
from reflexiv_tpu_torch import packed_dyn as pd
from reflexiv_tpu_torch.dyn_pool import (DynRecords, from_dyn_host,
                                         unpack_seq_matrix_np)
from reflexiv_tpu_torch.count import count_kmers
from reflexiv_tpu_torch.dynamic import sort_k_records
from reflexiv_tpu_torch.io import reads_to_matrix
from reflexiv_tpu_torch.mercy import mercy_kmer_table
from reflexiv_tpu_torch.params import Params

N = 8
MESH = parallel.make_mesh(["cpu"] * N)
KLIST = (21, 31, 41)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from reflexiv_tpu import checkpoint as jckpt
    from reflexiv_tpu import cli as jcli
    from reflexiv_tpu import dynamic as jdyn
    from reflexiv_tpu import packed_dyn as jpd
    from reflexiv_tpu import parallel as jpar
    from reflexiv_tpu.params import Params as JParams

    assert len(jax.devices()) >= N, "tests/conftest.py sets 8 CPU devices"
    return types.SimpleNamespace(
        jnp=jnp, pd=jpd, par=jpar, dyn=jdyn, ckpt=jckpt, cli=jcli,
        Params=JParams,
        mesh=jpar.make_mesh(jax.devices()[:N]))


def _reads(seed, genome_len=800, n_reads=400, read_len=70):
    """Exact substrings of a random genome, half reverse-complemented
    (``test_parallel.py``'s simulator)."""
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(genome_len))
    reads = []
    for _ in range(n_reads):
        s = rng.randrange(genome_len - read_len)
        r = genome[s:s + read_len]
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return reads


def _matrix(reads):
    return reads_to_matrix([r.encode() for r in reads])


def _rows(seq, length, subk, left, right, live=None):
    """Live rows of a packed pool in order: (bases, subk, left, right)."""
    seq, length, subk, left, right = (np.asarray(a) for a in
                                      (seq, length, subk, left, right))
    idx = np.arange(len(length)) if live is None \
        else np.nonzero(np.asarray(live))[0]
    bases = unpack_seq_matrix_np(seq[idx].astype(np.uint32),
                                 seq.shape[1] * 16)
    return list(zip((b[:n].tobytes() for b, n in zip(bases, length[idx])),
                    subk[idx].tolist(), left[idx].tolist(),
                    right[idx].tolist()))


def _jrows(p):
    return _rows(*p[:6])


def _frows(fp):
    return _rows(pd.to_dense(fp).numpy(), *(t.numpy() for t in fp[1:]))


def _byte_rows(d):
    """Rows of a byte pool (``DynRecords``), live ones in order."""
    return _rows(*from_dyn_host(DynRecords(*(np.asarray(a) for a in d)))[:6])


def _stage0_pool(jx, seed):
    """A stage 00 pool at KLIST (one card) as a JAX pool of 4096 rows, the
    live ones first, so every seed's rounds share one compiled shape."""
    mat, lens = _matrix(_reads(seed, 600, 300))
    params = Params(klist=KLIST, min_kmer_coverage=2)
    sets = []
    for k in KLIST:
        keys, counts = count_kmers(mat, lens, k=k, min_cov=2, device="cpu")
        sets.append((*sort_k_records(keys, counts, k, params), k))
    pool = meta.records_from_sorted(sets)
    cap = 4096
    assert pool.capacity <= cap

    def pad(a):
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return jx.jnp.asarray(out)

    return jx.pd.PackedDynRecords(*(pad(np.asarray(a)) for a in pool))


def _flat(jpool):
    live = np.asarray(jpool.live)
    return pd.from_dense(np.asarray(jpool.seq)[live],
                         *(np.asarray(a)[live] for a in jpool[1:5]))


@pytest.fixture(scope="module")
def pools(jx):
    return {seed: _stage0_pool(jx, seed) for seed in (1, 2, 3)}


@pytest.mark.parametrize("unique_only", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dense_round_matches_jax(jx, pools, seed, unique_only):
    """Rounds of the dense form on one device, row for row in output
    order, with the live count, ``need`` and the exact census."""
    jp, fp = pools[seed], _flat(pools[seed])
    max_sub = KLIST[-1] - 1
    merged = 0
    for it in range(1, 5):
        jp, live_n, need = jx.pd.pdyn_extension_round_fused(
            jp, jx.jnp.uint32(it), kmin=KLIST[0], max_sub=max_sub,
            unique_only=unique_only)
        fp, n, need2 = pd.pdyn_extension_round_fused(
            fp, it, kmin=KLIST[0], max_sub=max_sub, unique_only=unique_only)
        assert _frows(fp) == _jrows(jp)
        assert (n, need2) == (int(live_n), int(need))
        fin = np.asarray(jx.pd.finished_mask_pdyn_exact(jp, max_sub))
        np.testing.assert_array_equal(
            pd.finished_mask_pdyn_exact(fp, max_sub).numpy(),
            fin[np.asarray(jp.live)])
        merged += int((fp.length > KLIST[-1]).sum())
    assert merged > 20


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sharded_round_matches_jax_per_shard(jx, pools, seed):
    """Two sharded rounds from ``_pad_pdyn``'s layout: each shard's rows
    are the JAX shard's live rows, in order."""
    jp = pools[seed]
    n = int(np.asarray(jp.live).sum())
    cap = meta._mesh_capacity(n, N)
    jp = jx.dyn._pad_pdyn(jp, cap)
    shards = parallel.pad_pdyn([_flat(pools[seed])], cap, MESH)
    M = cap // N
    for it in (seed, seed + 1):
        jp, ovf = jx.par.pdyn_extension_round_sharded(
            jp, jx.jnp.uint32(it), kmin=KLIST[0], max_sub=KLIST[-1] - 1,
            mesh=jx.mesh, cap_factor=4)
        assert int(np.asarray(ovf).sum()) == 0
        shards = parallel.pdyn_extension_round_sharded(
            shards, it, kmin=KLIST[0], max_sub=KLIST[-1] - 1, mesh=MESH,
            cap=cap)
        for s, fp in enumerate(shards):
            part = jx.pd.PackedDynRecords(*(np.asarray(a)[s * M:(s + 1) * M]
                                            for a in jp))
            assert _frows(fp) == _jrows(part)
    assert sum(fp.n for fp in shards) < n


def test_census_park_and_merge_match_jax(jx):
    """On the parking case's pool (``_parking_pool``) after three rounds:
    the isolated rows are finished, the chain's are not."""
    recs, params, _ = _parking_pool()
    jp = jx.pd.from_dyn_host(recs)
    jp = jp._replace(seq=jx.jnp.pad(jp.seq, ((0, 0), (0, 124))))
    fp = _flat(jp)
    max_sub = params.k - 1
    for it in range(1, 4):
        jp, _, _ = jx.pd.pdyn_extension_round_fused(
            jp, jx.jnp.uint32(it), kmin=params.k, max_sub=max_sub)
        fp, _, _ = pd.pdyn_extension_round_fused(fp, it, kmin=params.k,
                                                 max_sub=max_sub)
    jfin = np.asarray(jx.pd.finished_mask_pdyn_exact(jp, max_sub))
    fin = pd.finished_mask_pdyn_exact(fp, max_sub)
    np.testing.assert_array_equal(fin.numpy(), jfin[np.asarray(jp.live)])
    assert 0 < int(fin.sum()) < fp.n
    jparked, parked = [], []
    jp = jx.pd.park_finished_pdyn(jp, jfin, jparked)
    fp = pd.park_finished_pdyn(fp, fin, parked)
    assert _frows(fp) == _jrows(jp)
    assert _frows(parked[0]) == _rows(*jparked[0])
    assert _frows(pd.merge_parked_pdyn(fp, parked)) == \
        _jrows(jx.pd.merge_parked_pdyn(jp, jparked))


def _parking_pool():
    """``test_parallel.py``'s parking case: a 1024-record overlap chain and
    600 isolated records, finished from round 1."""
    k, n_chain, n_iso = 21, 1024, 600
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, n_chain + k - 1, dtype=np.uint8)
    n = n_chain + n_iso
    seq = np.zeros((n, 64), np.uint8)
    length = np.zeros(n, np.int32)
    for i in range(n_chain):
        seq[i, :k] = genome[i:i + k]
        length[i] = k
    seq[n_chain:, :2 * k] = rng.integers(0, 4, size=(n_iso, 2 * k))
    length[n_chain:] = 2 * k
    return DynRecords(seq, length, np.full(n, k - 1, np.int32),
                      np.full(n, -3, np.int32), np.full(n, -3, np.int32),
                      np.ones(n, bool)), Params(k=k, min_iterations=15), {}


def _skew_pool():
    """``test_parallel.py``'s overflow case: 900 rows sharing one head
    key, so one shard gets every forward row."""
    k, n = 21, 900
    rng = np.random.default_rng(7)
    seq = np.zeros((n, 64), np.uint8)
    seq[:, :k - 1] = rng.integers(0, 4, size=k - 1, dtype=np.uint8)
    seq[:, k - 1:2 * k] = rng.integers(0, 4, size=(n, k + 1))
    return DynRecords(seq, np.full(n, 2 * k, np.int32),
                      np.full(n, k - 1, np.int32), np.full(n, -1, np.int32),
                      np.full(n, -1, np.int32), np.ones(n, bool)), \
        Params(k=k, min_iterations=1), {"max_rounds": 2}


@pytest.fixture(scope="module")
def loop_cases(jx, pools):
    p = pools[1]
    byte = DynRecords(*(np.asarray(a) for a in jx.pd.to_dyn_host(p)))
    return {"stage02": (byte, Params(klist=KLIST, min_iterations=15), {}),
            "parking": _parking_pool(), "skew": _skew_pool()}


def _jparams(jx, params):
    """The JAX package's Params with the same fields."""
    return jx.Params(**{f.name: getattr(params, f.name)
                        for f in dataclasses.fields(params)})


def _jax_loop(jx, recs, params, kmin, **kw):
    out = jx.dyn.run_dyn_extension(
        jx.dyn.DynRecords(*recs), _jparams(jx, params), kmin=kmin, kmax=kmin,
        mesh=jx.mesh, return_packed=True, **kw)
    return _jrows(out)


@pytest.mark.parametrize("case", ["stage02", "parking", "skew"])
def test_mesh_loop_matches_jax(jx, loop_cases, monkeypatch, caplog, case):
    """The mesh loop's pool after ``to_dyn_host``, row for row: a stage 02
    pool, the parking branch (it must fire in both packages) and the
    one-key skew, whose overflow retry must fire in both and lose no
    row."""
    recs, params, kw = loop_cases[case]
    kmin = KLIST[0] if case == "stage02" else params.k
    parks = {"jax": 0, "port": 0}
    jpark, tpark = jx.pd.park_finished_pdyn, pd.park_finished_pdyn

    def count(name, fn):
        def wrapped(*a):
            parks[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(jx.pd, "park_finished_pdyn", count("jax", jpark))
    monkeypatch.setattr(pd, "park_finished_pdyn", count("port", tpark))
    caplog.set_level(logging.INFO)
    want = _jax_loop(jx, recs, params, kmin, seed=0, **kw)
    jax_log = caplog.text
    caplog.clear()
    got = _frows(meta.run_dyn_extension_mesh(recs, params, kmin=kmin,
                                             seed=0, mesh=MESH, **kw))
    assert got == want
    if case == "parking":
        assert parks["jax"] >= 1 and parks["port"] >= 1
        assert max(len(b) for b, _, _, _ in got) == 1024 + 20
    # the same retries, at the same rounds and capacities: the layout
    # decides the JAX bucket overflows
    retries = re.compile(r"dyn round \d+ overflowed; repadding to \d+")
    assert retries.findall(caplog.text) == retries.findall(jax_log)
    if case == "skew":
        assert len(retries.findall(jax_log)) >= 2
        assert len(got) >= 900 - 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mesh_loop_checkpoint_resumes_across_packages(
        jx, loop_cases, monkeypatch, caplog, tmp_path, writer):
    """A loop stopped after round 5 with ``REFLEXIV_CKPT_EVERY_S=0`` leaves
    its state (``cap`` included); the other package resumes it and ends
    with the uninterrupted run's pool."""
    monkeypatch.setenv("REFLEXIV_CKPT_EVERY_S", "0")
    caplog.set_level(logging.INFO)
    recs, params, _ = loop_cases["stage02"]
    want = _jax_loop(jx, recs, params, KLIST[0], seed=0)
    d = str(tmp_path / "02partial")
    if writer == "jax":
        _jax_loop(jx, recs, params, KLIST[0], seed=0, max_rounds=5,
                  ckpt_dir=d)
        got = _frows(meta.run_dyn_extension_mesh(
            recs, params, kmin=KLIST[0], seed=0, mesh=MESH, ckpt_dir=d))
    else:
        meta.run_dyn_extension_mesh(recs, params, kmin=KLIST[0], seed=0,
                                    mesh=MESH, max_rounds=5, ckpt_dir=d)
        got = _jax_loop(jx, recs, params, KLIST[0], seed=0, ckpt_dir=d)
    assert "resuming at round 6" in caplog.text
    assert got == want


def _padded(mat, lens):
    R = -(-mat.shape[0] // N) * N
    bases = np.zeros((R, mat.shape[1]), np.uint8)
    bases[:mat.shape[0]] = mat
    ln = np.zeros(R, np.int32)
    ln[:mat.shape[0]] = lens
    return bases, ln


@pytest.mark.parametrize("bubble", [True, False])
@pytest.mark.parametrize("k", [21, 41])
def test_sort_k_records_sharded_matches_jax(jx, k, bubble):
    mat, lens = _matrix(_reads(13, 600, 300))
    kw = dict(klist=KLIST, min_kmer_coverage=2, bubble=bubble)
    bases, ln = _padded(mat, lens)
    want = jx.dyn.sort_k_records_sharded(
        jx.jnp.asarray(bases), jx.jnp.asarray(ln), k, jx.Params(**kw),
        jx.mesh)
    got = parallel.sort_k_records_sharded(mat, lens, k, Params(**kw),
                                          mesh=MESH)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 500


def test_mercy_table_sharded_matches_jax_and_single_card(jx):
    """``test_parallel.py``'s gap genome: a single read spans a starved
    30 bp stretch, so mercy k-mers exist."""
    rng = random.Random(31)
    genome = "".join(rng.choice("ACGT") for _ in range(1500))
    gap_lo, gap_hi = 700, 730
    reads = [genome[s:s + 100] for s in range(0, len(genome) - 100, 20)
             if not (s + 100 > gap_lo and s < gap_hi)]
    for off in (0, 3, 6, 9):
        reads.append(genome[gap_lo - 100 - off: gap_lo - off])
        reads.append(genome[gap_hi + off: gap_hi + off + 100])
    reads.append(genome[gap_lo - 35: gap_hi + 35])
    mat, lens = _matrix(reads)
    k = 21
    jl, jc = jx.par.mercy_kmer_table_sharded(mat, lens, k=k, min_cov=3,
                                             mesh=jx.mesh)
    keys, counts = parallel.mercy_kmer_table_sharded(mat, lens, k=k,
                                                     min_cov=3, mesh=MESH)
    skeys, scounts = mercy_kmer_table(mat, lens, k=k, min_cov=3,
                                      device="cpu")

    def table(keys, counts):
        return dict(zip(keys.tolist(), counts.tolist()))

    from reflexiv_tpu_torch.bitpack import keys_from_limbs

    got = table(keys, counts)
    assert got == table(keys_from_limbs(np.asarray(jl), k), np.asarray(jc))
    assert got == table(skeys, scounts)
    assert any(v < 3 for v in got.values())


def _fastq(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def test_cuda_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        meta.assemble_dynamic(*_matrix(_reads(41)), Params(klist=KLIST),
                              device="cpu",
                              mesh=parallel.make_mesh(["cuda"] * 4))


@pytest.mark.cuda
def test_cuda_mesh_meta_kernel_path_matches_plain(tmp_path):
    """On a card: ``meta`` on four virtual shards of ``cuda:0``, the
    kernels against their plain versions, the same ``Assembly/`` files;
    extraction and the sort launch once a shard at every k."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from reflexiv_tpu_torch.kernels import launch_counts

    mesh = parallel.make_mesh([torch.device("cuda", 0)] * 4)
    fq = tmp_path / "reads.fq"
    _fastq(fq, _reads(41))
    files = []
    for plain in (False, True):
        out = tmp_path / f"plain{int(plain)}"
        params = Params(klist=KLIST, min_kmer_coverage=2, min_contig=400,
                        min_iterations=15, input_fastq=str(fq),
                        output_path=str(out))
        before = launch_counts()
        meta.dynamic_assembly(params, device="cuda:0", mesh=mesh,
                              plain=plain)
        after = launch_counts()
        if not plain:
            # k = 21 and 31 are one word, k = 41 two
            for name, want in (("extract", 8), ("sort", 8),
                               ("extract_rows2", 4), ("sort_rows2", 4)):
                assert after.get(name, 0) - before.get(name, 0) >= want
        files.append([(out / "Assembly" / name).read_bytes() for name in
                      ("part-00000", "assembly_report.txt")])
    assert files[0] == files[1] and files[0][0]
