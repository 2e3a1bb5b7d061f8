"""Parity: the port's ``meta`` against ``reflexiv_tpu.dynamic``.

Whole assemblies, fixing, end extension, dedup, the CLI and the stage
checkpoints, on the same seeded inputs through both packages. Both run
the summary-indexed loop (``REFLEXIV_INDEXED_ALWAYS=1``, the JAX package's
TPU default; ``test_torch_meta_device_loop.py`` holds the default loop).
Exact: contig lists are equal, headers and order included, and files byte
for byte."""
import torch_threads  # noqa: F401
import os
import random
import shutil

import numpy as np
import pytest
import torch

import jax
import oracle
from reflexiv_tpu import checkpoint as jckpt
from reflexiv_tpu import dynamic as jdyn
from reflexiv_tpu import mapping as jmapping
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu.params import Params as JParams
from reflexiv_tpu_torch import checkpoint as tckpt
from reflexiv_tpu_torch import cli, dyn_pool, dynamic, mapping, meta, native
from reflexiv_tpu_torch.bitpack import decode_to_str, encode_ascii
from reflexiv_tpu_torch.params import Params


@pytest.fixture(autouse=True)
def _indexed_loop(monkeypatch):
    monkeypatch.setenv("REFLEXIV_INDEXED_ALWAYS", "1")


def _reads(seed, genome_bp, n_reads, read_len, err=0.005, genome=None):
    rng = random.Random(seed)
    g = genome or "".join(rng.choice("ACGT") for _ in range(genome_bp))
    reads = []
    for _ in range(n_reads):
        s = rng.randrange(len(g) - read_len + 1)
        r = "".join(c if rng.random() > err else rng.choice("ACGT")
                    for c in g[s:s + read_len])
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return g, reads


CASES = {
    # 3 kb genome, 100 bp reads, the default fixing (kmax >= 32)
    "3kb": dict(genome_bp=3000, n_reads=900, read_len=100,
                klist=(23, 31, 41), min_contig=500),
    # tests/test_dynamic.py's 500 bp case: kmax < 32, the unique fixing
    "500bp": dict(genome_bp=500, n_reads=300, read_len=60,
                  klist=(15, 21, 31), min_contig=300),
}


def _case(name):
    c = CASES[name]
    _g, reads = _reads(3, c["genome_bp"], c["n_reads"], c["read_len"])
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    kw = dict(klist=c["klist"], min_kmer_coverage=2,
              min_contig=c["min_contig"])
    return mat, lens, JParams(**kw), Params(**kw)


@pytest.fixture(scope="module")
def jax_3kb(tmp_path_factory):
    """The JAX package's 3 kb assembly, with its stage checkpoints."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REFLEXIV_INDEXED_ALWAYS", "1")
    mp.setattr(jdyn._RaggedPool, "W_DENSE", 16)
    mat, lens, jparams, _params = _case("3kb")
    steps = tmp_path_factory.mktemp("jax3kb") / "steps"
    contigs = jdyn.assemble_dynamic(mat, lens, jparams, seed=1,
                                    workdir=str(steps))
    mp.undo()
    return contigs, steps


@pytest.fixture
def dense16(monkeypatch):
    monkeypatch.setattr(jdyn._RaggedPool, "W_DENSE", 16)
    monkeypatch.setattr(dyn_pool.RaggedPool, "W_DENSE", 16)


def test_assemble_dynamic_matches_jax_3kb(jax_3kb, dense16):
    """Dense width 256 bases: the contig grows through overflow rows."""
    want, _steps = jax_3kb
    mat, lens, _jparams, params = _case("3kb")
    got = meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu")
    assert got == want
    assert max(len(s) for _h, s in got) > 16 * 16 * 4


def test_assemble_dynamic_fast_fixing_matches_jax(dense16, monkeypatch):
    """``REFLEXIV_FAST_FIXING=1``: the unique-overlap fixing at kmax >= 32."""
    monkeypatch.setenv("REFLEXIV_FAST_FIXING", "1")
    mat, lens, jparams, params = _case("3kb")
    want = jdyn.assemble_dynamic(mat, lens, jparams, seed=1)
    got = meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu")
    assert got == want and got


def test_assemble_dynamic_matches_jax_500bp(dense16):
    mat, lens, jparams, params = _case("500bp")
    want = jdyn.assemble_dynamic(mat, lens, jparams, seed=1)
    got = meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu")
    assert got == want and got


def _contig_rows(seed, overlap=None):
    """Contigs cut from a genome with overlaps of 40-90 bases (or exactly
    ``overlap``), some reverse-complemented, some ends blocked: fixing must
    re-join them."""
    rng = random.Random(seed)
    g = "".join(rng.choice("ACGT") for _ in range(3000))
    rows, at = [], 0
    while at < len(g) - 200:
        n = rng.randrange(150, 400)
        s = g[at:at + n]
        if rng.random() < 0.4:
            s = oracle.revcomp(s)
        codes = encode_ascii(np.frombuffer(s.encode(), np.uint8))
        rows.append((codes, 30, rng.choice((-5, -1, 7)),
                     rng.choice((-5, -1, 9))))
        at += n - (overlap or rng.randrange(40, 90))
    return rows


def _assert_groups_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fixing_rounds_faithful_matches_jax():
    rows = _contig_rows(5)
    groups = meta.groups_from_contig_rows(rows)
    _assert_groups_equal(groups, jdyn._groups_from_contig_rows(rows, 31))
    kmax = 41
    got_split = meta.fixing_split_groups(groups, kmax)
    want_split = jdyn._fixing_split_groups(groups, kmax)
    np.testing.assert_array_equal(got_split[0], want_split[0])
    _assert_groups_equal(got_split[1], want_split[1])
    params = Params(min_kmer_coverage=2, min_contig=100)
    got = meta.fixing_rounds_faithful(groups, params, kmax=kmax, seed=7,
                                      device="cpu")
    want = jdyn.fixing_rounds_faithful(
        groups, JParams(min_kmer_coverage=2, min_contig=100), kmax=kmax,
        seed=7)
    _assert_groups_equal(got, want)
    # some contigs re-joined through their shared end k-mers
    assert max(int(g[1].max()) for g in got) > max(len(r[0]) for r in rows)


def test_fixing_rounds_unique_matches_jax():
    """Neighbours overlap by exactly kfix - 1 = 20 bases, the unique
    fixing's join overlap."""
    rows = _contig_rows(6, overlap=20)
    got = meta.fixing_rounds(meta.dyn_pool_from_rows(rows), Params(),
                             kfix=21, seed=3, device="cpu")
    want = jdyn.fixing_rounds(jdyn._dyn_pool_from_rows(rows), JParams(),
                              kfix=21, seed=3)
    raw_got = meta._decode_pool_to_raw(got, Params(min_contig=1))
    idx = np.nonzero(np.asarray(want.live))[0]
    raw_want = [(decode_to_str(np.asarray(want.seq)[i, :int(want.length[i])]),
                 int(want.left[i]), int(want.right[i])) for i in idx]
    assert raw_got == raw_want
    assert len(raw_got) < len(rows)


def _boundary_reads():
    """Contig ends whose first extension column is voted exactly at the
    70% majority (7 of 10: taken), just under it (6 of 9: stops), and with
    one vote (under MIN_SUPPORT); the reads come from both strands."""
    rng = random.Random(8)
    contigs, reads = [], []
    for votes in ((7, 3), (6, 3), (1, 0), (12, 2)):
        g = "".join(rng.choice("ACGT") for _ in range(300))
        contigs.append(g[20:150])
        alt = "ACGT"[("ACGT".index(g[150]) + 1) % 4]
        for n, base in zip(votes, (g[150], alt)):
            for _ in range(n):
                start = rng.randrange(80, 118)
                r = g[start:150] + base + g[151:start + 100]
                reads.append(oracle.revcomp(r) if rng.random() < 0.5
                             else r)
        for _ in range(6):   # plain coverage of the contig's left end
            start = rng.randrange(0, 40)
            reads.append(g[start:start + 100])
    return contigs, reads


def test_end_extend_matches_jax_at_the_majority_boundary():
    contigs, reads = _boundary_reads()
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    want = jmapping.end_extend_arrays(contigs, mat, lens)
    got = mapping.end_extend_arrays(contigs, torch.from_numpy(mat),
                                    torch.from_numpy(lens))
    assert got == want
    grown = [len(g) - len(c) for g, c in zip(got, contigs)]
    assert grown[0] > 0 and grown[3] > 0       # 70% and 86% columns taken
    assert got[1].endswith(contigs[1][-20:])   # 67% stops at the end
    assert got[2].endswith(contigs[2][-20:])   # one vote stops too


def test_dedup_matches_jax():
    rng = random.Random(4)
    base = ["".join(rng.choice("ACGT") for _ in range(rng.randrange(20, 400)))
            for _ in range(40)]
    contigs = list(base)
    for s in base[:25]:
        i = rng.randrange(len(s) // 2)
        piece = s[i:i + rng.randrange(10, len(s) - i + 1)]
        contigs.append(oracle.revcomp(piece) if rng.random() < 0.5
                       else piece)
    contigs += base[:5] + [oracle.revcomp(s) for s in base[5:10]]
    rng.shuffle(contigs)
    want = jdyn.dedup_contigs(contigs)
    assert native.dedup_contigs_native(contigs) == want
    assert meta.dedup_contigs(contigs) == want
    assert meta.dedup_contigs_python(contigs) == want
    assert len(want) < len(set(contigs))


@pytest.mark.parametrize("eol", ["\n", "\r\n"])
def test_read_sorted_set_matches_jax(tmp_path, eol):
    """``meta`` reads a prior ``reduce``'s tables as whole arrays; lines
    ending in CR go the line-by-line way. Plain and gzip parts, negative
    and multi-digit attrs, blank lines."""
    import gzip

    rng = np.random.default_rng(12)
    k = 23
    d = tmp_path / f"Count_{k}_reduced"
    d.mkdir()
    for part, opener in (("part-00000", open), ("part-00001.gz", gzip.open)):
        lines = []
        for _ in range(300):
            km = "".join(rng.choice(list("ACGT"), k))
            l, r = (int(x) for x in rng.choice(
                [-1000000, -23, -1, 0, 7, 123456789], 2))
            lines.append(f"{km},{rng.integers(1, 3)}|{l}|{r}{eol}")
        lines.insert(100, eol)
        with opener(d / part, "wt", newline="") as fh:
            fh.write("".join(lines))
    got = dynamic.read_sorted_set(str(d), k)
    want = jdyn.read_sorted_set(str(d), k)
    assert len(got[0]) == 600
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _fastq(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def test_cli_reduce_then_meta_matches_jax(tmp_path, monkeypatch):
    """``reduce`` then ``meta`` into one -outfile, through both CLIs; the
    JAX CLI sees one device, as on a one-chip host."""
    from reflexiv_tpu.cli import main as jax_main

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    _g, reads = _reads(9, 2500, 700, 100)
    fq = tmp_path / "reads.fq"
    _fastq(fq, reads)
    args = ["-fastq", str(fq), "-cover", "2", "-klist", "23,31,41"]
    for pkg, main, extra in (("jax", jax_main, []),
                             ("port", cli.main, ["-device", "cpu"])):
        out = ["-outfile", str(tmp_path / pkg)] + extra
        assert main(["reduce"] + args + out) == 0
        assert main(["meta"] + args + out) == 0
    for name in ("part-00000", "assembly_report.txt", "_SUCCESS"):
        got = (tmp_path / "port" / "Assembly" / name).read_bytes()
        assert got == (tmp_path / "jax" / "Assembly" / name).read_bytes()
    assert (tmp_path / "port" / "Assembly" / "part-00000").stat().st_size
    for stage in ("01reduced", "02extended", "03fixed", "04contigs"):
        assert (tmp_path / "port" / "steps" / stage / "_SUCCESS").exists()
    import json

    met = json.loads((tmp_path / "port" / "metrics.json").read_text())
    for lap in ("02extend", "03fixing", "04reassemble_end_extend",
                "05extend_pass", "06finalize"):
        assert f"meta/{lap}" in met["stages_s"]
    assert met["counters"]["meta/contigs"] >= 1
    assert met["counters"]["meta/live_after_extension"] >= 1


@pytest.mark.parametrize("case", ["3kb", "500bp"])
def test_skip_extend_pass_matches_jax(monkeypatch, case):
    """``REFLEXIV_SKIP_EXTEND_PASS=1`` skips stage 05 in both packages."""
    monkeypatch.setenv("REFLEXIV_SKIP_EXTEND_PASS", "1")
    mat, lens, jparams, params = _case(case)
    want = jdyn.assemble_dynamic(mat, lens, jparams, seed=1)
    m = meta.metrics.reset()
    got = meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu")
    assert got == want and got
    assert "meta/05extend_pass" not in m.timers
    assert "meta/06finalize" in m.timers


def test_jax_checkpoint_resumes_in_the_port(jax_3kb, dense16, tmp_path):
    """Stages 00-02 written by the JAX package, the rest cleared: the port
    finishes from 02extended to the JAX contigs."""
    want, steps = jax_3kb
    work = tmp_path / "steps"
    shutil.copytree(steps, work)
    tckpt.clear_from(str(work), "03fixed")
    assert tckpt.latest_stage(str(work)) == "02extended"
    mat, lens, _jparams, params = _case("3kb")
    got = meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu",
                                workdir=str(work))
    assert got == want


def test_port_checkpoint_resumes_in_jax(jax_3kb, dense16, tmp_path):
    """The other way: the port writes every stage, the JAX package resumes
    from the port's 02extended."""
    want, _steps = jax_3kb
    work = tmp_path / "steps"
    mat, lens, jparams, params = _case("3kb")
    assert meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu",
                                 workdir=str(work)) == want
    jckpt.clear_from(str(work), "03fixed")
    assert jckpt.latest_stage(str(work)) == "02extended"
    assert jdyn.assemble_dynamic(mat, lens, jparams, seed=1,
                                 workdir=str(work)) == want


def test_port_resumes_from_00sorted(jax_3kb, dense16, tmp_path):
    """A straight run hands stage 00's per-k sets to stage 01 in memory; a
    run resumed at ``00sorted`` reads them back from the pool: the same
    contigs."""
    want, _steps = jax_3kb
    work = str(tmp_path / "steps")
    mat, lens, _jparams, params = _case("3kb")
    assert meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu",
                                 workdir=work) == want
    tckpt.clear_from(work, "01reduced")
    assert tckpt.latest_stage(work) == "00sorted"
    assert meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu",
                                 workdir=work) == want


def test_in_loop_checkpoint_resumes(jax_3kb, dense16, tmp_path, monkeypatch):
    """``REFLEXIV_CKPT_EVERY_S=0`` saves the loop after every round; a run
    cut after round 5 of stage 02 resumes from that save to the same
    contigs."""
    want, _steps = jax_3kb
    monkeypatch.setenv("REFLEXIV_CKPT_EVERY_S", "0")
    mat, lens, _jparams, params = _case("3kb")
    real, calls = meta.pdyn_round_indexed_host, []

    def cut_after_five(*a, **kw):
        calls.append(1)
        if len(calls) > 5:
            raise KeyboardInterrupt
        return real(*a, **kw)

    work = str(tmp_path / "steps")
    monkeypatch.setattr(meta, "pdyn_round_indexed_host", cut_after_five)
    with pytest.raises(KeyboardInterrupt):
        meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu",
                              workdir=work)
    monkeypatch.setattr(meta, "pdyn_round_indexed_host", real)
    assert os.path.exists(os.path.join(work, "02partial", "it_00005",
                                       "_SUCCESS"))
    assert tckpt.latest_stage(work) == "01reduced"
    got = meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu",
                                workdir=work)
    assert got == want
