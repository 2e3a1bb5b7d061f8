"""Parity: the port's ``reduce`` against ``reflexiv_tpu.dynamic``.

``sort_k_records`` and ``reduce_k_pair`` are compared array for array (row
order included), and the ``reduce`` command through both CLIs file for
file, byte for byte. Exact: everything is integer or text."""
import json
import os
import random

import numpy as np
import pytest
import torch

import oracle
from reflexiv_tpu import count as jcount
from reflexiv_tpu import dynamic as jdyn
from reflexiv_tpu.bitpack import encode_ascii
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu.params import Params as JParams
from reflexiv_tpu_torch import cli
from reflexiv_tpu_torch import dynamic as tdyn
from reflexiv_tpu_torch.bitpack import keys_from_limbs
from reflexiv_tpu_torch.params import Params


def _genome_reads(seed, genome_bp, n_reads, err=0.01):
    """100 bp both-strand reads with substitutions from a genome with a
    repeat (so groups fork) and a poly-T run."""
    rng = random.Random(seed)
    g = "".join(rng.choice("ACGT") for _ in range(genome_bp))
    g = g[:genome_bp // 3] + "T" * 60 + g[genome_bp // 3:] + g[100:260]
    reads = []
    for _ in range(n_reads):
        s = rng.randrange(len(g) - 100)
        r = "".join(c if rng.random() > err else rng.choice("ACGT")
                    for c in g[s:s + 100])
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return reads


def _assert_triples_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def sorted_sets():
    """JAX count + sort_k_records per k of the tested pairs; the port's
    sort_k_records on the same tables must give the same arrays."""
    reads = _genome_reads(5, 1500, 160)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    params = Params(min_kmer_coverage=2)
    jparams = JParams(min_kmer_coverage=2)
    out = {}
    for k in (23, 31, 67, 81, 95):
        limbs, counts = jcount.count_kmers(mat, lens, k=k, min_cov=2)
        want = jdyn.sort_k_records(limbs, counts, k, jparams)
        got = tdyn.sort_k_records(keys_from_limbs(limbs, k),
                                  torch.from_numpy(counts), k, params)
        _assert_triples_equal(got, want)
        out[k] = want
    return out


def _mk(rows, k):
    bases = np.stack([encode_ascii(np.frombuffer(s.encode(), np.uint8))
                      for s, _, _ in rows])
    return (bases, np.asarray([l for _, l, _ in rows], np.int32),
            np.asarray([r for _, _, r in rows], np.int32))


@pytest.mark.parametrize("shorts,longs", [
    # tests/test_dynamic.py::test_reduce_prefix_subsumption
    ([("ACGTA", -3, -3), ("GGGTT", -3, -3)],
     [("ACGTACCA", -3, -3), ("TTTTAAAA", -3, -3)]),
    # tests/test_dynamic.py::test_reduce_right_end_attr_inheritance
    ([("GTACA", -3, -9)], [("AAAGTACC", -3, 4)]),
])
def test_reduce_k_pair_matches_jax_on_the_dynamic_cases(shorts, longs):
    s, l = _mk(shorts, 5), _mk(longs, 8)
    want = jdyn.reduce_k_pair(s, l, 5, 8)
    got = tdyn.reduce_k_pair(s, l, 5, 8, device="cpu")
    for g, w in zip(got, want):
        _assert_triples_equal(g, w)


@pytest.mark.parametrize("k1,k2", [(23, 31), (67, 81), (81, 95)])
def test_reduce_k_pair_matches_jax(sorted_sets, k1, k2):
    want = jdyn.reduce_k_pair(sorted_sets[k1], sorted_sets[k2], k1, k2)
    got = tdyn.reduce_k_pair(sorted_sets[k1], sorted_sets[k2], k1, k2,
                             device="cpu")
    for g, w in zip(got, want):
        _assert_triples_equal(g, w)
    # the pair did reduce something: shorts dropped or longs adjusted
    assert len(want[0][0]) < len(sorted_sets[k1][0]) or not all(
        np.array_equal(a, b) for a, b in zip(want[1], sorted_sets[k2]))


def _tree(root):
    """Relative path -> bytes of every file but metrics.json."""
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            if f != "metrics.json":
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def reduce_runs(tmp_path_factory):
    """``reduce`` at the default klist through both CLIs on a 5 kb genome."""
    from reflexiv_tpu.cli import main as jax_main

    d = tmp_path_factory.mktemp("reduce")
    fq = d / "reads.fq"
    reads = _genome_reads(7, 5000, 500, err=0.005)
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    args = ["reduce", "-fastq", str(fq), "-cover", "2"]
    assert jax_main(args + ["-outfile", str(d / "jax")]) == 0
    assert cli.main(args + ["-outfile", str(d / "port"),
                            "-device", "cpu"]) == 0
    return d, args


def test_cli_reduce_writes_the_jax_files(reduce_runs):
    d, _args = reduce_runs
    want, got = _tree(d / "jax"), _tree(d / "port")
    names = {f"Count_{k}_{s}/{f}" for k in (23, 31, 41, 53, 67, 81, 95)
             for s in ("sorted", "reduced") for f in ("part-00000.csv",
                                                      "_SUCCESS")}
    names |= {"Stitch_kmer/Count_31_sorted/part-00000.csv",
              "Stitch_kmer/Count_31_sorted/_SUCCESS", "reduce_params.json"}
    assert set(want) == names
    assert set(got) == names
    for name in sorted(names):
        assert got[name] == want[name], name
    with open(d / "port" / "metrics.json") as fh:
        met = json.load(fh)
    for stage in ("ingest", "count", "sort", "pair", "write"):
        assert f"reduce/{stage}" in met["stages_s"]
    assert met["counters"]["reduce/records_k95"] > 0


def test_cli_reduce_resumes_from_success_markers(reduce_runs):
    """A second run over a finished output skips every stage and leaves
    every file as it was."""
    d, args = reduce_runs
    before = _tree(d / "port")
    mtimes = {p: os.path.getmtime(d / "port" / p) for p in before
              if p != "reduce_params.json"}
    assert cli.main(args + ["-outfile", str(d / "port"),
                            "-device", "cpu"]) == 0
    assert _tree(d / "port") == before
    assert all(os.path.getmtime(d / "port" / p) == t
               for p, t in mtimes.items())
    with open(d / "port" / "metrics.json") as fh:
        stages = json.load(fh)["stages_s"]
    assert not any(f"reduce/{s}" in stages
                   for s in ("count", "sort", "pair", "write"))


def test_cli_reduce_resumes_a_cut_ladder_like_jax(reduce_runs, tmp_path):
    """Cut after the first pair: both packages finish the ladder from the
    markers left, to the same files."""
    import shutil

    from reflexiv_tpu.cli import main as jax_main

    d, args = reduce_runs
    for pkg in ("jax", "port"):
        shutil.copytree(d / "port", tmp_path / pkg)
        for k in (31, 41, 53, 67, 81, 95):
            shutil.rmtree(tmp_path / pkg / f"Count_{k}_reduced")
        shutil.rmtree(tmp_path / pkg / "Stitch_kmer")
    assert jax_main(args + ["-outfile", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["-outfile", str(tmp_path / "port"),
                            "-device", "cpu"]) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == _tree(d / "port")


def test_cli_reduce_refuses_accurate(tmp_path, capsys):
    assert cli.main(["reduce", "-fastq", "x.fq", "-accurate",
                     "-outfile", str(tmp_path), "-device", "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_cli_run_keeps_its_one_word_bound(tmp_path):
    with pytest.raises(ValueError, match="k=41"):
        cli.main(["run", "-fastq", "x.fq", "-kmer", "41",
                  "-outfile", str(tmp_path), "-device", "cpu"])
