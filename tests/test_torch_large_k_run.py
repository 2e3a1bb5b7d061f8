"""Parity above k = 31: the port's extension round, census and single-k
assembly on multi-word group keys against the JAX package's CPU forms
(the stable lexsort round, the non-scatter-free census), row for row; then
``run``, ``mercy`` and read-graph reassembly at k = 41 and 61. Exact:
integers and text."""
import torch_threads  # noqa: F401
import dataclasses
import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import oracle
from reflexiv_tpu import assembler as jasm
from reflexiv_tpu import count as jcount
from reflexiv_tpu import packed as jpk
from reflexiv_tpu.assembler import assemble_reads as jax_assemble
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu.params import Params
from reflexiv_tpu.records import next_pow2
from reflexiv_tpu.reassemble import reassemble_arrays as jax_reassemble
from reflexiv_tpu_torch import packed as tpk
from reflexiv_tpu_torch.assembler import assemble_reads
from reflexiv_tpu_torch.reassemble import reassemble_arrays
from test_torch_assemble import (_case_600bp, _case_errors,
                                 _case_two_chromosomes, _write_fastq)
from test_torch_packed import _assert_equal, _to_torch
from test_torch_patching import run_both


def _reads(seed=11, genome_bp=900, read_len=100, depth=25, err=0.01):
    rng = random.Random(seed)
    g = "".join(rng.choice("ACGT") for _ in range(genome_bp))
    reads = []
    for _ in range(genome_bp * depth // read_len):
        s = rng.randrange(genome_bp - read_len)
        r = "".join(c if rng.random() > err else rng.choice("ACGT")
                    for c in g[s:s + read_len])
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return g, reads


def _jax_state(k, rounds):
    """A JAX pool at ``k`` after ``rounds`` rounds of a synthetic with
    errors, so forks, tips and merged rows of several lengths are there."""
    _g, reads = _reads()
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    limbs, counts = jcount.count_kmers(mat, lens, k=k, min_cov=2)
    recs, _ = jasm.initial_records_from_counts(
        limbs, counts, Params(k=k, min_kmer_coverage=2))
    p = jpk.from_records(recs)
    need = 2 * int(jnp.max(jnp.where(p.live, p.length, 0))) - (k - 1)
    for it in range(1, rounds + 1):
        if need > p.base_capacity:
            p = jpk.grow_packed(p, next_pow2(need))
        p, _n, need = jpk._extension_round_packed(
            p, jnp.uint32(100 + it), k=k, variadic=False, partner_fill=False)
        need = int(need)
    return p


@pytest.fixture(scope="module")
def states():
    return {(k, r): _jax_state(k, r) for k in (33, 41, 65) for r in (0, 3)}


@pytest.mark.parametrize("rounds", [0, 3])
@pytest.mark.parametrize("k", [33, 41, 65])
@pytest.mark.parametrize("seed", [1, 2])
def test_round_matches_jax_row_for_row(states, k, rounds, seed):
    jp = states[(k, rounds)]
    tp = _to_torch(jp)
    jout, jn, jneed = jpk._extension_round_packed(
        jp, jnp.uint32(seed), k=k, variadic=False, partner_fill=False)
    tout, tn, tneed = tpk.extension_round_packed(tp, seed, k=k)
    _assert_equal(tout, jout)
    assert int(tn) == int(jn) and int(tneed) == int(jneed)
    assert int(tn) < int(tp.live.sum())      # the round merged something


@pytest.mark.parametrize("rounds", [0, 3])
@pytest.mark.parametrize("k", [33, 41, 65])
def test_census_and_keys_match_jax(states, k, rounds):
    jp = states[(k, rounds)]
    tp = _to_torch(jp)
    fin = tpk.finished_mask_packed(tp, k).numpy()
    np.testing.assert_array_equal(
        fin, np.asarray(jpk._finished_mask_packed(jp, k, scatter_free=False)))
    m = jpk.draw_markers_packed(jp, jnp.uint32(5))
    want = np.asarray(jpk.derive_keys_packed(jp, m, k)).astype(np.int64)
    got = tpk.derive_keys_packed(tp, torch.from_numpy(np.array(m)), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dead_rows_tie_with_poly_t_as_in_jax():
    """At k = 33 a key fills its two limbs exactly, so a live poly-T key
    equals a dead row's all-ones limbs: both packages keep the rows' pool
    order inside that group."""
    k, n = 33, 8
    seq = np.zeros((n, 64), np.uint8)
    seq[:, :k] = 3
    seq[1::2, k - 1] = 0                 # half the rows end in A, not T
    length = np.full(n, k, np.int32)
    live = np.array([1, 0, 1, 1, 0, 1, 1, 0], bool)
    left = -np.arange(1, n + 1, dtype=np.int32)
    jp = jpk.PackedRecords(jpk.pack_seq_matrix(jnp.asarray(seq)),
                           jnp.asarray(length), jnp.asarray(left),
                           jnp.asarray(left), jnp.asarray(live))
    for seed in range(4):
        jout, _n, _need = jpk._extension_round_packed(
            jp, jnp.uint32(seed), k=k, variadic=False, partner_fill=False)
        tout, _n, _need = tpk.extension_round_packed(_to_torch(jp), seed, k=k)
        _assert_equal(tout, jout)


@pytest.mark.parametrize("case,k", [(_case_600bp, 41), (_case_errors, 41),
                                    (_case_two_chromosomes, 41),
                                    (_case_errors, 61)])
def test_assembly_matches_jax(case, k):
    reads, params, seed = case()
    params = dataclasses.replace(params, k=k, min_contig=100)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    want = jax_assemble(mat, lens, params, seed=seed)
    got = assemble_reads(mat, lens, params, seed=seed, device="cpu")
    assert got == want and len(got) >= 2


@pytest.fixture(scope="module")
def reads_fq(tmp_path_factory):
    d = tmp_path_factory.mktemp("large_k_cli")
    _g, reads = _reads(seed=5, genome_bp=3000, depth=30, err=0.004)
    fq = str(d / "reads.fq")
    _write_fastq(fq, reads)
    return d, fq


@pytest.mark.parametrize("cmd", ["run", "mercy"])
def test_cli_matches_jax_at_k41(reads_fq, cmd, monkeypatch):
    d, fq = reads_fq
    root = d / cmd
    run_both([cmd, "-fastq", fq, "-kmer", "41", "-cover", "3",
              "-mincontig", "300"], root, monkeypatch)
    want = (root / "jax" / "part-00000").read_bytes()
    assert (root / "port" / "part-00000").read_bytes() == want
    assert want.count(b">") >= 2
    if cmd == "run":
        assert (root / "port" / "assembly_report.txt").read_bytes() == \
            (root / "jax" / "assembly_report.txt").read_bytes()


def test_reassemble_arrays_matches_jax_at_k41():
    g, reads = _reads(seed=8, genome_bp=1500, depth=30, err=0.0)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    frags = [g[400:700], oracle.revcomp(g[900:1150]), g[100:141]]
    params = Params(k=41, min_kmer_coverage=2, min_contig=300)
    want = jax_reassemble(mat, lens, frags, params, seed=3)
    got = reassemble_arrays(mat, lens, frags, params, seed=3, device="cpu")
    assert got == want
    assert max(len(s) for _h, s in got) > 600
