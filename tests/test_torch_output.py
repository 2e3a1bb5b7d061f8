"""The output layer: contigs spelled on the device by ``emit_contigs`` and
written from those bytes (``part-00000``, ``assembly_report.txt``) against
the JAX package's ``emit_contigs``, ``write_contigs_fasta`` and
``write_assembly_report`` over the same rows. Exact: bytes."""
import torch_threads  # noqa: F401
import gzip
import json
import os
import random

import numpy as np
import pytest
import torch

from reflexiv_tpu import contigs as jcontigs
from reflexiv_tpu import io as jio
from reflexiv_tpu.records import Records as JaxRecords
from reflexiv_tpu_torch import cli, contigs, io, metrics
from reflexiv_tpu_torch import packed as pk
from reflexiv_tpu_torch.bitpack import encode_ascii

revcomp = jcontigs.revcomp_str


def _genome(rng, n, gc=0.5):
    at, cg = (1 - gc) / 2, gc / 2
    return "".join(rng.choices("ACGT", weights=[at, cg, cg, at], k=n))


def _line_edges(rng):
    return [_genome(rng, n) for n in (1, 99, 100, 101, 200, 201, 37)], {}


def _palindromes(rng):
    # exact ones, and ones whose strands agree but for two middle bases:
    # the canonical strand is the forward one ("AC") or the other ("TG")
    half, near = _genome(rng, 150), _genome(rng, 120)
    return [half + revcomp(half), "ACGT", near + "AC" + revcomp(near),
            near + "TG" + revcomp(near), _genome(rng, 300)], {}


def _strand_pair(rng):
    s = _genome(rng, 333)
    return [s, _genome(rng, 250), revcomp(s)], {}


def _equal_lengths(rng):
    # one length, GC from 10% to 90%: the report's rows follow the set
    return [_genome(rng, 240, gc=0.1 + 0.02 * i) for i in range(40)], {}


def _longer_than_a_chunk(rng):
    return [_genome(rng, n) for n in (30, 300, 5, 64, 65, 129)], \
        {"EMIT_BASES": 64}


def _none(rng):
    return [], {}


CASES = [_line_edges, _palindromes, _strand_pair, _equal_lengths,
         _longer_than_a_chunk, _none]


def _rows(seqs, rng):
    """Every contig as a live row, between rows the emission drops: dead
    ones and a repeat-killed one."""
    rows = []
    for s in seqs:
        rows.append((s, rng.randrange(-5, 5), rng.randrange(-5, 5), True))
        rows.append((_genome(rng, 50), 1, 2, False))
    return rows + [(_genome(rng, 60), -10_000_000, -10_000_001, True)]


def _groups(rows, device="cpu"):
    """The rows as two packed groups (the pool and a parked batch), and as
    one JAX record set in the same order."""
    width = max([len(s) for s, *_ in rows] + [1])
    mat = np.zeros((len(rows), width), np.uint8)
    for i, (s, *_r) in enumerate(rows):
        mat[i, :len(s)] = encode_ascii(np.frombuffer(s.encode(), np.uint8))
    length = np.array([len(s) for s, *_ in rows], np.int32)
    left = np.array([r[1] for r in rows], np.int32)
    right = np.array([r[2] for r in rows], np.int32)
    live = np.array([r[3] for r in rows], bool)
    limbs = pk.pack_seq_matrix(torch.from_numpy(mat))
    cut = len(rows) // 2
    groups = [pk.PackedRecords(limbs[a:b].to(device),
                               *(torch.from_numpy(x[a:b]).to(device)
                                 for x in (length, left, right, live)))
              for a, b in ((0, cut), (cut, len(rows)))]
    return groups, JaxRecords(mat, length, left, right, live)


def _read(path, gz):
    with (gzip.open if gz else open)(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[1:])
def test_spelled_output_matches_jax(tmp_path, monkeypatch, case, gz):
    rng = random.Random(case.__name__)
    seqs, patch = case(rng)
    for name, value in patch.items():
        monkeypatch.setattr(contigs, name, value)
    groups, jrecs = _groups(_rows(seqs, rng))
    met = metrics.reset()
    got = contigs.emit_contigs(groups, min_contig=1)
    want = jcontigs.emit_contigs(jrecs, min_contig=1)
    assert got == want
    assert [s for _, s in got] == seqs
    assert got.spelled is not None
    assert met.counts.get("output/spelled_bases", 0) == sum(map(len, seqs))
    assert met.counts.get("output/spelled_chunks", 0) == len(got.spelled)
    if patch:
        assert len(got.spelled) >= 4
    for side, pairs, mod in (("port", got, (io, contigs)),
                             ("jax", want, (jio, jcontigs))):
        os.makedirs(tmp_path / side)
        mod[0].write_contigs_fasta(str(tmp_path / side / "part-00000"),
                                   pairs, gzip_output=gz)
        mod[1].write_assembly_report(
            str(tmp_path / side / "assembly_report.txt"), pairs)
    assert _read(tmp_path / "port" / "part-00000", gz) == \
        _read(tmp_path / "jax" / "part-00000", gz)
    assert (tmp_path / "port" / "assembly_report.txt").read_bytes() == \
        (tmp_path / "jax" / "assembly_report.txt").read_bytes()
    # the string path reads the same
    assert contigs.assembly_stats(got) == contigs.assembly_stats(list(got))


def test_an_edited_list_is_written_from_its_strings(tmp_path):
    rng = random.Random(3)
    seqs = [_genome(rng, n) for n in (150, 220, 90)]
    groups, _j = _groups(_rows(seqs, rng))
    got = contigs.emit_contigs(groups, min_contig=1)
    head, seq = got[0]
    got[0] = (head, ("A" if seq[0] != "A" else "C") + seq[1:])
    assert got.spelled is None
    io.write_contigs_fasta(str(tmp_path / "port.fa"), got)
    jio.write_contigs_fasta(str(tmp_path / "jax.fa"), list(got))
    assert (tmp_path / "port.fa").read_bytes() == \
        (tmp_path / "jax.fa").read_bytes()


def _fastq(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def test_cli_run_counts_spelled_bases_and_times_both_files(tmp_path):
    rng = random.Random(5)
    genome = _genome(rng, 900)
    reads = []
    for _ in range(900 * 25 // 60):
        s = rng.randrange(len(genome) - 60)
        r = genome[s:s + 60]
        reads.append(revcomp(r) if rng.random() < 0.5 else r)
    fq = str(tmp_path / "reads.fq")
    _fastq(fq, reads)
    out = str(tmp_path / "asm")
    assert cli.main(["run", "-fastq", fq, "-kmer", "21", "-cover", "2",
                     "-mincontig", "300", "-outfile", out,
                     "-device", "cpu"]) == 0
    with open(os.path.join(out, "metrics.json")) as fh:
        got = json.load(fh)
    fasta = [s.decode() for _, s in
             io.iter_fasta([os.path.join(out, "part-00000")])]
    assert len(fasta) >= 2
    assert got["counters"]["output/spelled_bases"] == sum(map(len, fasta))
    assert got["counters"]["output/spelled_chunks"] >= 1
    for span in ("output/fasta", "output/report"):
        assert 0 < got["stages_s"][span] <= got["stages_s"]["run/output"]
    # merger writes host strings: nothing spelled
    merged = str(tmp_path / "merged")
    assert cli.main(["merger", "-fasta", os.path.join(out, "part-00000"),
                     "-outfile", merged, "-device", "cpu"]) == 0
    with open(os.path.join(merged, "metrics.json")) as fh:
        counters = json.load(fh)["counters"]
    assert counters.get("output/spelled_bases", 0) == 0
