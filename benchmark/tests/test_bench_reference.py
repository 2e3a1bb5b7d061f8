"""The plain reference against the program's plain path at 200 kb, and the
control (the reference counting by a 32-bit fingerprint) against the
reference, on the configurations' own rules and repeat families."""
import pytest

from benchlib.manifest import Cell, load_manifest
from benchlib.traffic import make_input

SMALL_BP = 200_000
SMALL_REPEATS = [[3, 2000], [4, 768], [5, 1195]]


def small_cell(name):
    cell = Cell(load_manifest(), name)
    cell.config = dict(cell.config, genome_bp=SMALL_BP,
                       repeats=SMALL_REPEATS)
    return cell


def program_contigs(cell, fastq, outdir):
    from reflexiv_tpu_torch import cli

    assert cli.main(cell.command.argv(cell.config, fastq, outdir, "cpu")) == 0
    return cell.command.job_contigs(outdir)


@pytest.mark.parametrize("name, seed", [
    ("run.isolate_k31.30x", 2**33 + 1),
    ("run.isolate_k31.30x", 17),
    ("run.isolate_k67.30x", 2**35 + 3),
])
def test_reference_equals_the_programs_plain_path(tmp_path, name, seed):
    cell = small_cell(name)
    fastq = str(tmp_path / "reads.fq.gz")
    make_input(fastq, cell.config, cell.traffic, seed)
    got = program_contigs(cell, fastq, str(tmp_path / "out"))
    ref = cell.command.assemble_reference(cell.config, fastq, "cpu")
    assert got == ref["canonical"]
    assert sum(map(len, got)) > 0.9 * SMALL_BP


# the control's fingerprint at 200 kb: 27 bits give a solid k-mer the
# chance of a collision that 32 bits give it at the cells' 4,641,652 bp
# (about 2^-4.5 as many k-mers)
SMALL_FINGERPRINT_BITS = 27


@pytest.mark.parametrize("seed", [101, 2**40 + 7, 31337])
def test_control_fails_the_comparison(tmp_path, seed):
    """Counting by a short fingerprint of the k-mer (colliding k-mers share
    a count) changes the contigs: the exact comparison catches it."""
    cell = small_cell("run.isolate_k31.30x")
    fastq = str(tmp_path / "reads.fq.gz")
    make_input(fastq, cell.config, cell.traffic, seed)
    exact = cell.command.assemble_reference(cell.config, fastq, "cpu")
    ctl = cell.command.assemble_reference(
        cell.config, fastq, "cpu", fingerprint_bits=SMALL_FINGERPRINT_BITS)
    assert len(exact["canonical"] ^ ctl["canonical"]) > 0
