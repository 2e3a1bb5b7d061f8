"""Parity: the port's ``reassembler``, ``merger`` and ``stitch`` against the
JAX package's, through both CLIs on the cases of ``tests/test_subsystems.py``
(file for file, byte for byte), the chain pool against the packed pool,
and the CLI's dispatch. Exact: text and integers."""
import torch_threads  # noqa: F401
import random

import pytest
import torch

import oracle
from reflexiv_tpu import count as jcount
from reflexiv_tpu.assembler import assemble_reads as jax_assemble
from reflexiv_tpu.dynamic import _write_sorted_set, sort_k_records
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu.params import Params
from reflexiv_tpu.stitch import stitch_contigs as jax_stitch
from reflexiv_tpu_torch import chains, cli, metrics
from reflexiv_tpu_torch.assembler import (initial_records_from_counts,
                                          run_extension_loop)
from reflexiv_tpu_torch.contigs import emit_contigs
from reflexiv_tpu_torch.count import count_kmers
from reflexiv_tpu_torch.reassemble import (inject_fragments,
                                           remove_fragment_kmers)
from reflexiv_tpu_torch.stitch import _stitch_records_from_table, \
    stitch_contigs
from test_torch_assemble import _write_fastq
from test_torch_mercy import _tree
from test_torch_patching import run_both


def _sim_reads(rng, genome, read_len, coverage):
    """tests/test_subsystems.py's simulator at error rate 0, same draws."""
    reads = []
    for _ in range(coverage * len(genome) // read_len):
        s = rng.randrange(len(genome) - read_len + 1)
        r = genome[s:s + read_len]
        for _ in r:
            rng.random()
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return reads


def _write_fasta(path, seqs):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">c{i}\n{s}\n")


def _reassembler_case(giant: bool):
    """tests/test_subsystems.py:31 (and :52 with the giant fragment)."""
    rng = random.Random(77)
    genome = "".join(rng.choice("ACGT") for _ in range(700))
    frags = [genome[250:450]]
    if giant:
        frags.append("".join(rng.choice("ACGT") for _ in range(4096)))
    return _sim_reads(rng, genome, 60, 30), frags


@pytest.mark.parametrize("giant", [False, True])
def test_cli_reassembler_matches_jax(tmp_path, monkeypatch, giant):
    reads, frags = _reassembler_case(giant)
    fq, fa = str(tmp_path / "r.fq"), str(tmp_path / "f.fa")
    _write_fastq(fq, reads)
    _write_fasta(fa, frags)
    if giant:
        monkeypatch.setenv("REFLEXIV_REASSEMBLE_BYTES", "4000000")
    run_both(["reassembler", "-fastq", fq, "-frag", fa, "-kmer", "21",
              "-cover", "2", "-mincontig", "400", "-seed", "1"],
             tmp_path, monkeypatch)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert set(got) == set(want) == {"Assemble_21/part-00000",
                                     "Assemble_21/_SUCCESS"}
    assert got == want
    longest = max(len(s) for s in want["Assemble_21/part-00000"]
                  .replace(b"\n", b"").split(b">")[1:])
    assert longest >= 600


def test_cli_merger_matches_jax(tmp_path, monkeypatch):
    rng = random.Random(3)
    a = "".join(rng.choice("ACGT") for _ in range(300))
    b = "".join(rng.choice("ACGT") for _ in range(200))
    fa = str(tmp_path / "c.fa")
    _write_fasta(fa, [a, a[50:200], oracle.revcomp(a[100:250]), b, b])
    run_both(["merger", "-fasta", fa], tmp_path, monkeypatch)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got == want and set(got) == {"Merged/part-00000",
                                        "Merged/_SUCCESS"}
    assert want["Merged/part-00000"].count(b">") == 2


def _gap_reads():
    """tests/test_subsystems.py:169: deep flanks, a sparse single-copy
    tiling over the middle."""
    rng = random.Random(99)
    genome = "".join(rng.choice("ACGT") for _ in range(700))
    reads = [genome[s:s + 60] for s in (rng.randrange(0, 220)
                                        for _ in range(180))]
    reads += [genome[s:s + 60] for s in (rng.randrange(380, 640)
                                         for _ in range(180))]
    reads += [genome[s:s + 60] for s in range(230, 390, 25)]
    return genome, reads


@pytest.fixture(scope="module")
def gap_case(tmp_path_factory):
    d = tmp_path_factory.mktemp("stitch")
    genome, reads = _gap_reads()
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    params = Params(k=21, min_kmer_coverage=2, min_contig=150)
    base = [s for _, s in jax_assemble(mat, lens, params, seed=4)]
    fq, fa = str(d / "r.fq"), str(d / "base.fa")
    _write_fastq(fq, reads)
    _write_fasta(fa, base)
    return d, genome, mat, lens, base, fq, fa


def test_stitch_contigs_matches_jax(gap_case):
    _d, genome, mat, lens, base, _fq, _fa = gap_case
    params = Params(k=21, min_kmer_coverage=2, min_contig=150)
    want = jax_stitch(mat, lens, base, params, klist=(21,), seed=4)
    met = metrics.reset()
    got = stitch_contigs(mat, lens, base, params, klist=(21,), seed=4,
                         device="cpu")
    assert got == want
    # a stitch's rounds are its own counter a k, never run's
    assert met.counts["stitch/extension_rounds_k21"] > 0
    assert "run/extension_rounds" not in met.counts
    best = max(got, key=len)
    assert len(best) >= 600
    assert best in genome or oracle.revcomp(best) in genome


def test_cli_stitch_matches_jax(gap_case, monkeypatch):
    d, _g, _m, _l, _b, fq, fa = gap_case
    root = d / "cli"
    run_both(["stitch", "-fastq", fq, "-frag", fa, "-cover", "2",
              "-mincontig", "150", "-seed", "4"], root, monkeypatch)
    want, got = _tree(root / "jax"), _tree(root / "port")
    assert got == want
    assert {"Assembly_stitched_21/part-00000", "Assembly_stitched_31/_SUCCESS",
            "Assembly_stitched_61/part-00000"} <= set(got)


def _table_case(tmp_path, k):
    """tests/test_subsystems.py:368: a Stitch_kmer table written by the
    JAX package's reduce writer."""
    rng = random.Random(3)
    genome = "".join(rng.choice("ACGT") for _ in range(400))
    reads = [genome[i:i + 60] for i in range(0, 330, 6)]
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    params = Params(k=k, min_kmer_coverage=1, output_path=str(tmp_path))
    limbs, counts = jcount.count_kmers(mat, lens, k=k, min_cov=1)
    _write_sorted_set(str(tmp_path / "Stitch_kmer" / f"Count_{k}_sorted"),
                      sort_k_records(limbs, counts, k, params), k)
    return genome, reads, mat, lens, params


def test_stitch_records_from_table_match_counted(tmp_path):
    k = 21
    _g, _r, mat, lens, params = _table_case(tmp_path, k)
    recs = _stitch_records_from_table(params, k, "cpu")
    keys, counts = count_kmers(mat, lens, k=k, min_cov=1, device="cpu")
    want, _n = initial_records_from_counts(keys, counts, params)

    def live_rows(r):
        live = torch.nonzero(r.live).squeeze(1)
        return sorted(zip(map(bytes, r.seq[live, :k].numpy()),
                          r.left[live].tolist(), r.right[live].tolist()))

    assert live_rows(recs) == live_rows(want)
    assert _stitch_records_from_table(
        Params(k=k, output_path=str(tmp_path / "nope")), k, "cpu") is None


def test_cli_stitch_reuses_the_table_like_jax(tmp_path, monkeypatch):
    genome, reads, _m, _l, _p = _table_case(tmp_path / "jax", 31)
    _table_case(tmp_path / "port", 31)
    fq, fa = str(tmp_path / "r.fq"), str(tmp_path / "f.fa")
    _write_fastq(fq, reads)
    _write_fasta(fa, [genome[10:150], oracle.revcomp(genome[200:330])])
    run_both(["stitch", "-fastq", fq, "-frag", fa, "-mincontig", "100"],
             tmp_path, monkeypatch)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got == want and "Assembly_stitched_31/part-00000" in got


@pytest.mark.parametrize("k", [21, 33])
def test_chain_pool_matches_packed_pool(k):
    """The chain pool's loop gives the packed loop's contigs, headers and
    order, with fragments injected and without."""
    rng = random.Random(12)
    genome = "".join(rng.choice("ACGT") for _ in range(1200))
    reads = []
    for _ in range(1200 * 20 // 70):
        s = rng.randrange(len(genome) - 70)
        r = "".join(c if rng.random() > 0.01 else rng.choice("ACGT")
                    for c in genome[s:s + 70])
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    params = Params(k=k, min_kmer_coverage=1, min_contig=k + 4)
    keys, counts = count_kmers(mat, lens, k=k, min_cov=1, device="cpu")
    recs, _n = initial_records_from_counts(keys, counts, params)
    for frags in ([], [genome[100:400], oracle.revcomp(genome[700:950])]):
        r = remove_fragment_kmers(recs, frags, k)
        want = emit_contigs(run_extension_loop(inject_fragments(r, frags, k),
                                               params, seed=9),
                            min_contig=params.min_contig)
        pool, pieces = chains.from_records(r, frags, k)
        got = chains.emit_contigs(
            chains.run_extension_loop(pool, pieces, params, seed=9), pieces,
            k=k, min_contig=params.min_contig)
        assert got == want and len(got) >= 10


def test_every_command_dispatches():
    assert cli.PORTED == cli.COMMANDS
    for name in cli.COMMANDS:
        assert callable(getattr(cli, f"cmd_{name}"))


@pytest.mark.parametrize("cmd", ["run", "mercy", "reassembler"])
def test_cli_k_above_max_k_raises(tmp_path, cmd):
    with pytest.raises(ValueError, match="k=101"):
        cli.main([cmd, "-fastq", "x.fq", "-kmer", "101",
                  "-outfile", str(tmp_path), "-device", "cpu"])
