"""Parity: the port's ``preprocess`` against ``reflexiv_tpu.preprocess``:
pair merging (native and numpy), the solid table's values, correction in
each of its forms against the same JAX form on the cases of
``tests/test_subsystems.py`` and ``tests/test_native.py``, and the
``preprocess`` CLI on single, paired and interleaved input, file for file.
Exact: integer matrices and text."""
import torch_threads  # noqa: F401
import random

import numpy as np
import pytest

import oracle
from reflexiv_tpu import native as jnative
from reflexiv_tpu import preprocess as jpre
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu_torch import native as tnative
from reflexiv_tpu_torch import preprocess as tpre
from test_torch_commands import _sim_reads
from test_torch_mercy import _tree
from test_torch_patching import run_both


def _rand(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _pairs_127():
    rng = random.Random(8)
    insert = _rand(rng, 150)
    other = _rand(rng, 100)
    return [(insert[:100], oracle.revcomp(insert[50:150])),
            (insert[:100], oracle.revcomp(other))]


def _pairs_335():
    rng = random.Random(9)
    pairs = []
    for _ in range(40):
        insert = _rand(rng, rng.randrange(90, 220))
        n1, n2 = rng.randrange(60, 101), rng.randrange(60, 101)
        pairs.append((insert[:n1], oracle.revcomp(insert[-n2:])))
    return pairs


def _pairs_native_31():
    rng = random.Random(2)
    pairs = []
    for _ in range(30):
        insert = _rand(rng, 140)
        pairs.append((insert[:90], oracle.revcomp(insert[60:140])))
    pairs.append((_rand(rng, 90), _rand(rng, 90)))
    return pairs


@pytest.mark.parametrize("form", ["native", "numpy"])
@pytest.mark.parametrize("case", [_pairs_127, _pairs_335, _pairs_native_31])
def test_merge_pairs_matches_jax(case, form, monkeypatch):
    pairs = case()
    m1, l1 = reads_to_matrix([a.encode() for a, _ in pairs])
    m2, l2 = reads_to_matrix([b.encode() for _, b in pairs])
    if form == "numpy":
        monkeypatch.setattr(jnative, "merge_pairs_native", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "merge_pairs_native", lambda *a, **k: None)
    else:
        assert tnative.merge_pairs_native(
            m1, l1, m2, l2, min_overlap=10, max_mismatch=0.25) is not None
    want, wmask = jpre.merge_pairs(m1, l1, m2, l2)
    got, gmask = tpre.merge_pairs(m1, l1, m2, l2)
    np.testing.assert_array_equal(gmask, wmask)
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert wmask.any()


def _errors_149():
    rng = random.Random(12)
    genome = _rand(rng, 300)
    reads = _sim_reads_err(rng, genome, 80, 25, rc=False)
    bad = list(reads[0])
    bad[40] = next(c for c in "ACGT" if c != bad[40])
    reads[0] = "".join(bad)
    return reads, None


def _sim_reads_err(rng, genome, read_len, coverage, rc=True):
    """tests/test_subsystems.py's ``_sim_reads`` at error rate 0."""
    if rc:
        return _sim_reads(rng, genome, read_len, coverage)
    reads = []
    for _ in range(coverage * len(genome) // read_len):
        s = rng.randrange(len(genome) - read_len + 1)
        r = genome[s:s + read_len]
        for _ in r:
            rng.random()
        reads.append(r)
    return reads


def _plant(reads, rows, positions):
    for i, p in zip(rows, positions):
        bad = list(reads[i])
        bad[p] = next(c for c in "ACGT" if c != bad[p])
        reads[i] = "".join(bad)


def _errors_281():
    rng = random.Random(41)
    genome = _rand(rng, 600)
    reads = _sim_reads_err(rng, genome, 90, 120)
    for i in range(0, len(reads), 5):
        _plant(reads, [i, i], [17, 63])
    return reads, None


def _errors_305():
    rng = random.Random(43)
    genome = _rand(rng, 2000)
    reads = _sim_reads_err(rng, genome, 80, 500)
    for i in range(0, len(reads), 4):
        _plant(reads, [i], [rng.randrange(5, len(reads[i]) - 5)])
    return reads, None


def _errors_457():
    rng = random.Random(47)
    genome = _rand(rng, 600)
    reads = _sim_reads_err(rng, genome, 90, 150, rc=False)
    _plant(reads, [0, 10], [40, 40])
    return reads, (10, 40)


def _errors_503():
    rng = random.Random(47)
    genome = _rand(rng, 1500)
    reads = _sim_reads_err(rng, genome, 80, 400)
    for i in range(0, len(reads), 3):
        _plant(reads, [i], [rng.randrange(5, len(reads[i]) - 5)])
    return reads, None


def _errors_native_211():
    rng = random.Random(61)
    genome = _rand(rng, 1200)
    reads = []
    for _ in range(400):
        s = rng.randrange(len(genome) - 90)
        reads.append(genome[s:s + 90])
    for i in range(0, len(reads), 6):
        p = rng.randrange(10, 80)
        bad = list(reads[i])
        bad[p] = next(c for c in "ACGT" if c != bad[p])
        if i % 12 == 0 and p + 8 < 80:
            bad[p + 8] = next(c for c in "ACGT" if c != bad[p + 8])
        reads[i] = "".join(bad)
    return reads, None


# the JAX single dispatch evaluates every slot of its cap, padding too, so
# a cap above the weak sets here (a few thousand) only slows the reference
MODES = {
    "native": {},
    "device_single": {"REFLEXIV_DEVICE_STAGES": "1",
                      "REFLEXIV_DISPATCH_CAP": "8192"},
    "device_chunked": {"REFLEXIV_DEVICE_STAGES": "1",
                       "REFLEXIV_SINGLE_DISPATCH": "0"},
    "numpy": {"REFLEXIV_DEVICE_STAGES": "0"},
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", [_errors_149, _errors_281, _errors_457,
                                  _errors_native_211])
def test_correct_reads_matches_jax(case, mode, monkeypatch):
    reads, low_q = case()
    for name, value in MODES[mode].items():
        monkeypatch.setenv(name, value)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    kw = dict(k=21, min_cov=3)
    if low_q is not None:      # the -trustqual case: phred 40 but one base
        quals = np.full(mat.shape, 40, np.uint8)
        quals[low_q] = 5
        kw.update(quals=quals, trust_qual=30)
    want, n_want = jpre.correct_reads(mat, lens, **kw)
    got, n_got = tpre.correct_reads(mat, lens, device="cpu", **kw)
    assert n_got == n_want >= 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["device_single", "device_chunked"])
def test_device_correction_matches_jax_on_the_large_case(mode, monkeypatch):
    reads, _q = _errors_305()
    for name, value in MODES[mode].items():
        monkeypatch.setenv(name, value)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    want, n_want = jpre.correct_reads_device(mat, lens, k=21, min_cov=3)
    got, n_got = tpre.correct_reads_device(mat, lens, k=21, min_cov=3,
                                           device="cpu")
    assert n_got == n_want >= 10
    np.testing.assert_array_equal(got, want)


def test_dispatch_cap_rotation_matches_jax(monkeypatch):
    """A cap below the weak set: the attempted mask rotates through it
    (``tests/test_subsystems.py:503``)."""
    reads, _q = _errors_503()
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    monkeypatch.setenv("REFLEXIV_DISPATCH_CAP", "256")
    want, n_want = jpre.correct_reads_device(mat, lens, k=21, min_cov=3)
    got, n_got = tpre.correct_reads_device(mat, lens, k=21, min_cov=3,
                                           device="cpu")
    assert n_got == n_want >= 10
    np.testing.assert_array_equal(got, want)


def test_scalar_oracle_and_solid_table_match_jax():
    reads, _q = _errors_281()
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    want, n_want = jpre.correct_reads_scalar(mat, lens, k=21, min_cov=3)
    got, n_got = tpre.correct_reads_scalar(mat, lens, k=21, min_cov=3)
    assert n_got == n_want >= 1
    np.testing.assert_array_equal(got, want)
    for k in (21, 23, 31, 32):
        wvals, _l, wcounts = jpre._solid_table(mat, lens, k, 3)
        gvals, _keys, gcounts = tpre._solid_table(mat, lens, k, 3,
                                                  device="cpu")
        assert gvals.dtype == np.uint64 and len(gvals) > 100
        np.testing.assert_array_equal(gvals, wvals)
        np.testing.assert_array_equal(gcounts.numpy(), wcounts)


def _write_fq(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@p{i}\n{r}\n+\n{'I' * len(r)}\n")


def _library(seed=21, genome_bp=1500):
    """Overlapping pairs (160 bp fragments, 2 x 100 bp, 40 bp overlap)
    with a substitution in every fourth mate, and a few pairs that do
    not overlap."""
    rng = random.Random(seed)
    g = _rand(rng, genome_bp)
    pairs = []
    for j, s in enumerate(range(0, genome_bp - 300, 7)):
        ins = 160 if j % 9 else 260
        r1, r2 = g[s:s + 100], oracle.revcomp(g[s + ins - 100:s + ins])
        if j % 4 == 0:
            p = rng.randrange(100)
            r1 = r1[:p] + next(c for c in "ACGT" if c != r1[p]) + r1[p + 1:]
        pairs.append((r1, r2))
    return pairs


@pytest.mark.parametrize("layout", ["single", "single_trustqual", "paired",
                                    "interleaved"])
def test_cli_preprocess_matches_jax(tmp_path, monkeypatch, layout):
    pairs = _library()
    if layout == "interleaved":
        fq = str(tmp_path / "inter.fq")
        _write_fq(fq, [r for pair in pairs for r in pair])
        args = ["-inter", fq]
    elif layout == "paired":
        paths = [str(tmp_path / f"m{j}.fq") for j in (1, 2)]
        for j, path in enumerate(paths):
            _write_fq(path, [p[j] for p in pairs])
        args = ["-fastq", ",".join(paths)]
    else:
        fq = str(tmp_path / "single.fq")
        _write_fq(fq, [p[0] for p in pairs] + [p[1] for p in pairs])
        args = ["-fastq", fq]
        if layout == "single_trustqual":
            args += ["-trustqual", "30"]
    run_both(["preprocess"] + args + ["-kmer", "21", "-cover", "2"],
             tmp_path, monkeypatch)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got == want
    assert "Read_Repartitioned/part-00000.fq" in got
    merged = {"paired": "Read_Paired_Merged", "interleaved":
              "Read_Interleaved_Merged"}.get(layout)
    if merged:
        assert f"{merged}/_SUCCESS" in got
