"""Parity of the port's sharded path (``reflexiv_tpu_torch.parallel``)
with the JAX package's (``reflexiv_tpu.parallel``): the JAX side on the 8
virtual CPU devices of ``tests/conftest.py``, the port on
``make_mesh(["cpu"] * 8)``. Every comparison is exact: per-shard count
tables and rounds row for row, fork-filtered sets, census masks, contig
sets and the CLI's ``part-00000``.

The JAX imports live in the ``jx`` fixture, so the ``cuda`` test imports
no jax and runs on a card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_parallel.py``."""
import dataclasses
import os
import random
import types

import numpy as np
import pytest
import torch

import oracle
from reflexiv_tpu_torch import cli, metrics, parallel
from reflexiv_tpu_torch import count as tcount
from reflexiv_tpu_torch import packed as pk
from reflexiv_tpu_torch.assembler import assemble_reads
from reflexiv_tpu_torch.bitpack import limbs_from_keys, num_words
from reflexiv_tpu_torch.contigs import canonical_set
from reflexiv_tpu_torch.count import count_kmers
from reflexiv_tpu_torch.io import reads_to_matrix
from reflexiv_tpu_torch.params import Params
from reflexiv_tpu_torch.records import Records

N = 8
MESH = parallel.make_mesh(["cpu"] * N)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from reflexiv_tpu import cli as jcli
    from reflexiv_tpu import packed as jpk
    from reflexiv_tpu import parallel as jpar
    from reflexiv_tpu.records import Records as JRecords

    assert len(jax.devices()) >= N, "tests/conftest.py sets 8 CPU devices"
    return types.SimpleNamespace(
        jnp=jnp, par=jpar, pk=jpk, cli=jcli, Records=JRecords,
        mesh=jpar.make_mesh(jax.devices()[:N]))


def _reads(seed, genome_len=500, n_reads=250, read_len=60):
    """The read simulator of ``test_parallel.py``: exact substrings of a
    random genome, half reverse-complemented."""
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(genome_len))
    reads = []
    for _ in range(n_reads):
        s = rng.randrange(genome_len - read_len)
        r = genome[s:s + read_len]
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return reads_to_matrix([r.encode() for r in reads])


def _padded(mat, lens):
    """Rows padded to a multiple of the shard count, as the JAX sharded
    wrappers pad them (``parallel.py:734-738``)."""
    R = -(-mat.shape[0] // N) * N
    bases = np.zeros((R, mat.shape[1]), np.uint8)
    bases[:mat.shape[0]] = mat
    ln = np.zeros(R, np.int32)
    ln[:mat.shape[0]] = lens
    return bases, ln


def _per_shard(x):
    x = np.asarray(x)
    return x.reshape((N, -1) + x.shape[1:])


def _jax_tables(jx, mat, lens, k, min_cov):
    bases, ln = _padded(mat, lens)
    limbs, counts, keep, ovf = jx.par.count_kmers_sharded(
        jx.jnp.asarray(bases), jx.jnp.asarray(ln), k=k, min_cov=min_cov,
        mesh=jx.mesh)
    assert int(np.asarray(ovf).sum()) == 0
    return limbs, counts, keep


@pytest.mark.parametrize("k,passes", [(21, "one"), (41, "one"),
                                      (21, "limit"), (41, "limit"),
                                      (21, "partition")])
def test_count_tables_match_jax_per_shard(jx, monkeypatch, k, passes):
    """One counting pass a shard, or several: under a forced small window
    limit (3 passes of 15 of a shard's 32 reads) or ``-partition 32`` (4
    passes of 8), the per-shard tables are the same."""
    mat, lens = _reads(13)
    limbs, counts, keep = _jax_tables(jx, mat, lens, k, 2)
    if passes == "limit":
        monkeypatch.setattr(tcount, "STREAM_WINDOW_LIMIT",
                            15 * (60 - k + 1) * num_words(k))
    metrics.reset()
    got = parallel.count_kmers_sharded(
        mat, lens, k=k, min_cov=2, mesh=MESH,
        partitions=32 if passes == "partition" else 0)
    assert metrics.current().counts["count.chunks"] == \
        {"one": 1, "limit": 3, "partition": 4}[passes]
    seen = set()
    for s, (keys, cnt) in enumerate(got):
        kept = _per_shard(keep)[s]
        want_limbs = _per_shard(limbs)[s][kept]
        got_limbs = limbs_from_keys(keys, k).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got_limbs, want_limbs)
        np.testing.assert_array_equal(cnt.numpy(), _per_shard(counts)[s][kept])
        rows = {r.tobytes() for r in got_limbs}
        assert not rows & seen, "a key on two shards"
        seen |= rows
    keys, cnt = count_kmers(mat, lens, k=k, min_cov=2, device="cpu")
    union = torch.cat([t for t, _ in got])
    order = union.argsort() if union.dim() == 1 else \
        torch.from_numpy(np.lexsort(union.numpy().T[::-1]).copy())
    torch.testing.assert_close(union[order], keys, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([c for _, c in got])[order], cnt,
                               rtol=0, atol=0)


def _live_set(seq, length, left, right, live):
    return {(bytes(np.asarray(seq[i, :length[i]], np.uint8)), int(left[i]),
             int(right[i])) for i in np.nonzero(np.asarray(live))[0]}


@pytest.mark.parametrize("bubble", [True, False])
def test_fork_filter_matches_jax_per_shard(jx, bubble):
    k = 21
    mat, lens = _reads(31)
    limbs, counts, keep = _jax_tables(jx, mat, lens, k, 2)
    out = jx.par.build_initial_records_sharded(
        limbs, counts, keep, k=k, min_error=8, mesh=jx.mesh, bubble=bubble)
    assert int(np.asarray(out[5]).sum()) == 0
    tables = parallel.count_kmers_sharded(mat, lens, k=k, min_cov=2,
                                          mesh=MESH)
    recs = parallel.build_initial_records_sharded(
        tables, k=k, min_error=8, mesh=MESH, bubble=bubble)
    for s, r in enumerate(recs):
        want = _live_set(*(_per_shard(x)[s] for x in out[:5]))
        got = _live_set(r.seq.numpy(), r.length.numpy(), r.left.numpy(),
                        r.right.numpy(), r.live.numpy())
        assert got == want and len(got) == r.capacity
    assert sum(r.capacity for r in recs) > 500


def _shard_pool(k=21, seed=31):
    """Per-shard packed pools of the port's sharded fork filter, each laid
    out by ``_pad_rows`` in the same rows and width the JAX loop uses."""
    mat, lens = _reads(seed)
    tables = parallel.count_kmers_sharded(mat, lens, k=k, min_cov=2,
                                          mesh=MESH)
    recs = parallel.build_initial_records_sharded(
        tables, k=k, min_error=8, mesh=MESH)
    M = max(2 * max(r.capacity for r in recs), 16)
    return [pk.from_records(parallel._pad_rows(r, M, 64)) for r in recs]


def _to_jax(jx, pools):
    """Per-shard packed pools (equal rows) -> one JAX pool, shard-major."""
    cat = [torch.cat(cols).numpy() for cols in zip(*pools)]
    return jx.pk.PackedRecords(jx.jnp.asarray(cat[0].astype(np.uint32)),
                               *(jx.jnp.asarray(c) for c in cat[1:]))


def _rows(p, s=None):
    """Live rows of a pool, in order: (seq limbs, length, left, right)."""
    cols = [np.asarray(c) if s is None else _per_shard(c)[s] for c in p]
    live = cols[4].astype(bool)
    return [cols[0][live].astype(np.int64)] + [c[live] for c in cols[1:4]]


@pytest.mark.parametrize("k,seed", [(21, 1), (21, 2), (21, 3), (21, 4),
                                    (41, 1)])
def test_round_matches_jax_per_shard(jx, k, seed):
    pools = _shard_pool(k)
    want, ovf = jx.par.extension_round_sharded_packed(
        _to_jax(jx, pools), jx.jnp.uint32(seed), k=k, mesh=jx.mesh,
        cap_factor=N)
    assert int(np.asarray(ovf).sum()) == 0
    got = parallel.extension_round_sharded_packed(pools, seed, k=k,
                                                  mesh=MESH)
    merged = 0
    for s, p in enumerate(got):
        for a, b in zip(_rows(p), _rows(want, s)):
            np.testing.assert_array_equal(a, b)
        merged += int((p.length[p.live] > k).sum())
    assert merged > 20


def test_census_matches_single_card_and_jax(jx):
    k = 21
    pools = _shard_pool(k)
    for it in range(1, 15):     # some rows finished by now, not all
        pools = parallel.extension_round_sharded_packed(pools, it, k=k,
                                                        mesh=MESH)
    M = max(p.capacity for p in pools)
    pools = [parallel._pad_rows(p, M, p.limb_capacity) for p in pools]
    got = parallel.finished_mask_sharded(pools, k=k, mesh=MESH)
    whole = pk.PackedRecords(*(torch.cat(c) for c in zip(*pools)))
    single = pk.finished_mask_packed(whole, k)
    want = jx.par.finished_mask_sharded(_to_jax(jx, pools), k=k,
                                        mesh=jx.mesh)
    torch.testing.assert_close(torch.cat(got), single)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))
    assert 0 < int(single.sum()) < int(whole.live.sum())


def test_skewed_round_loses_no_row(jx):
    """Every record shares one head key (``test_dyn_sharded_overflow_
    retries``' input): one shard receives every forward row. The JAX
    round needs room for it; here nothing is dropped, and the round
    equals the single-card round of both packages as a multiset."""
    k, n = 21, 900
    rng = np.random.default_rng(7)
    seq = np.zeros((n, 64), np.uint8)
    seq[:, :k - 1] = rng.integers(0, 4, size=k - 1, dtype=np.uint8)
    seq[:, k - 1:2 * k] = rng.integers(0, 4, size=(n, k + 1))
    recs = Records(
        torch.from_numpy(seq), torch.full((n,), 2 * k, dtype=torch.int32),
        torch.full((n,), -1, dtype=torch.int32),
        torch.full((n,), -1, dtype=torch.int32),
        torch.ones(n, dtype=torch.bool))
    whole = pk.from_records(recs)
    shards = [pk.PackedRecords(*(t[s::N] for t in whole)) for s in range(N)]
    got = parallel.extension_round_sharded_packed(shards, 3, k=k, mesh=MESH)
    assert max(int(p.live.sum()) for p in got) > n // 4
    single, live_n, _ = pk.extension_round_packed(whole, 3, k=k)
    jsingle, _, _ = jx.pk.extension_round_packed(
        jx.pk.from_records(jx.Records(*(jx.jnp.asarray(t.numpy())
                                        for t in recs))),
        jx.jnp.uint32(3), k=k)

    def multiset(rows):
        return sorted(zip(map(bytes, rows[0].astype(np.uint32)),
                          *(r.tolist() for r in rows[1:])))

    want = multiset(_rows(single))
    assert multiset([np.concatenate(c) for c in
                     zip(*(_rows(p) for p in got))]) == want
    assert multiset(_rows(jsingle)) == want
    assert sum(int(p.live.sum()) for p in got) == int(live_n)


def _assembly_case():
    mat, lens = _reads(71)
    return mat, lens, Params(k=21, min_kmer_coverage=2, min_contig=300,
                             min_iterations=12)


def test_assembly_matches_jax_sharded_and_single_card(jx):
    mat, lens, params = _assembly_case()
    want = jx.par.assemble_reads_sharded(mat, lens, params, mesh=jx.mesh,
                                         seed=2)
    from reflexiv_tpu import metrics as jmetrics

    want_rounds = jmetrics.current().counts["sharded/extension_rounds"]
    metrics.reset()
    got = parallel.assemble_reads_sharded(mat, lens, params, mesh=MESH,
                                          seed=2)
    assert metrics.current().counts["sharded/extension_rounds"] == \
        want_rounds
    single = assemble_reads(mat, lens, params, seed=2, device="cpu")
    assert got == want                 # headers and order too
    assert canonical_set(got) == canonical_set(single)
    assert len(got) >= 2


def _write_fastq(path, mat, lens):
    with open(path, "w") as fh:
        for i, (row, n) in enumerate(zip(mat, lens)):
            r = "".join("ACGT"[c] for c in row[:n])
            fh.write(f"@r{i}\n{r}\n+\n{'I' * n}\n")


def test_cmd_run_on_a_mesh_matches_jax_cli(jx, tmp_path):
    """``cmd_run(..., mesh=)`` writes the JAX CLI's sharded ``run``
    output (which meshes over the 8 CPU devices) byte for byte."""
    mat, lens, params = _assembly_case()
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, mat, lens)
    jout = str(tmp_path / "jax")
    assert jx.cli.main(["run", "-fastq", fq, "-kmer", "21", "-cover", "2",
                        "-mincontig", "300", "-miniter", "12", "-seed", "2",
                        "-outfile", jout]) == 0
    out = str(tmp_path / "port")
    metrics.reset()
    cli.cmd_run(dataclasses.replace(params, input_fastq=fq, output_path=out),
                2, "cpu", mesh=MESH)
    assert metrics.current().counts["sharded/extension_rounds"] > 0
    with open(os.path.join(jout, "metrics.json")) as fh:
        assert "sharded/extension_rounds" in fh.read()
    for name in ("part-00000", "assembly_report.txt"):
        with open(os.path.join(out, name)) as a, \
                open(os.path.join(jout, name)) as b:
            assert a.read() == b.read(), name


def test_cmd_run_on_a_mesh_ignores_clips_as_jax_cli(jx, tmp_path):
    """The JAX sharded count takes no clips, so its mesh ``run`` ignores
    ``-clipf``/``-clipe``; the port's copies that: with the clips set,
    ``part-00000`` and the report equal the JAX CLI's byte for byte."""
    mat, lens, params = _assembly_case()
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, mat, lens)
    jout = str(tmp_path / "jax")
    assert jx.cli.main(["run", "-fastq", fq, "-kmer", "21", "-cover", "2",
                        "-mincontig", "300", "-miniter", "12", "-seed", "2",
                        "-clipf", "5", "-clipe", "7", "-outfile", jout]) == 0
    out = str(tmp_path / "port")
    cli.cmd_run(dataclasses.replace(params, input_fastq=fq, output_path=out,
                                    front_clip=5, end_clip=7),
                2, "cpu", mesh=MESH)
    for name in ("part-00000", "assembly_report.txt"):
        with open(os.path.join(out, name)) as a, \
                open(os.path.join(jout, name)) as b:
            assert a.read() == b.read(), name
    # the clips would have changed the contigs: one card applies them
    clipped = assemble_reads(mat, lens, dataclasses.replace(
        params, front_clip=5, end_clip=7), seed=2, device="cpu")
    with open(os.path.join(out, "part-00000")) as fh:
        seqs = [ln for ln in fh.read().split() if not ln.startswith(">")]
    assert sorted(s for _, s in clipped) != sorted(seqs)


def test_auto_mesh_only_for_bare_cuda():
    assert cli._auto_mesh("cpu") is None
    assert cli._auto_mesh(torch.device("cpu")) is None
    assert cli._auto_mesh("cuda:0") is None
    assert cli._auto_mesh("cuda:3") is None


def test_cuda_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.make_mesh(["cuda"] * 4)


@pytest.mark.cuda
def test_cuda_mesh_kernel_path_matches_plain():
    """On a card: four virtual shards of ``cuda:0``, kernels against their
    plain versions, the same contig list."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from reflexiv_tpu_torch.kernels import extract, radix_sort

    mesh = parallel.make_mesh([torch.device("cuda", 0)] * 4)
    mat, lens, params = _assembly_case()
    before = (extract.LAUNCHES, radix_sort.LAUNCHES)
    got = parallel.assemble_reads_sharded(mat, lens, params, mesh=mesh,
                                          seed=2)
    assert extract.LAUNCHES - before[0] == 4
    assert radix_sort.LAUNCHES - before[1] == 4
    plain = parallel.assemble_reads_sharded(mat, lens, params, mesh=mesh,
                                            seed=2, plain=True)
    assert got == plain and len(got) >= 2


@pytest.mark.cuda
def test_cuda_mesh_over_every_card_matches_one_card():
    """On a machine with several cards: ``-device cuda``'s mesh spans them
    all, rows cross cards in every exchange, and the contigs equal the
    one-card assembly's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    mesh = cli._auto_mesh("cuda")
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count()))
    mat, lens, params = _assembly_case()
    got = parallel.assemble_reads_sharded(mat, lens, params, mesh=mesh,
                                          seed=2)
    one = assemble_reads(mat, lens, params, seed=2, device="cuda:0")
    assert canonical_set(got) == canonical_set(one) and len(got) >= 2
