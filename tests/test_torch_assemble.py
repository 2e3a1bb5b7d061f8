"""End-to-end parity: the port's single-k ``run`` against the JAX package's
on the ``test_e2e.py`` synthetics, the CLI's output layout, and the rule
that the port never imports jax. Exact: the contig lists are equal."""
import os
import random
import subprocess
import sys

import pytest
import torch

import oracle
from reflexiv_tpu import io as jio
from reflexiv_tpu.assembler import assemble_reads as jax_assemble
from reflexiv_tpu.contigs import canonical_set as jax_canonical_set
from reflexiv_tpu.contigs import write_assembly_report as jax_report
from reflexiv_tpu.params import Params
from reflexiv_tpu_torch import cli
from reflexiv_tpu_torch.assembler import assemble_reads
from reflexiv_tpu_torch.contigs import canonical_set
from reflexiv_tpu_torch.io import iter_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _simulate(rng, genome, read_len, coverage, err_rate=0.0):
    """The read simulator of tests/test_e2e.py."""
    reads = []
    for _ in range(coverage * len(genome) // read_len):
        s = rng.randrange(len(genome) - read_len + 1)
        r = list(genome[s:s + read_len])
        for i in range(len(r)):
            if rng.random() < err_rate:
                r[i] = rng.choice("ACGT")
        r = "".join(r)
        if rng.random() < 0.5:
            r = oracle.revcomp(r)
        reads.append(r)
    return reads


def _genome(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _case_600bp():
    rng = random.Random(42)
    genome = _genome(rng, 600)
    return (_simulate(rng, genome, 60, 30),
            Params(k=21, min_kmer_coverage=2, min_contig=300), 1)


def _case_errors():
    rng = random.Random(7)
    genome = _genome(rng, 500)
    return (_simulate(rng, genome, 80, 20, err_rate=0.005),
            Params(k=21, min_kmer_coverage=3, min_contig=250), 3)


def _case_two_chromosomes():
    rng = random.Random(9)
    g1, g2 = _genome(rng, 400), _genome(rng, 400)
    return (_simulate(rng, g1, 60, 30) + _simulate(rng, g2, 60, 30),
            Params(k=21, min_kmer_coverage=2, min_contig=200), 5)


@pytest.mark.parametrize("case", [_case_600bp, _case_errors,
                                  _case_two_chromosomes])
def test_assembly_matches_jax(case):
    reads, params, seed = case()
    mat, lens = jio.reads_to_matrix([r.encode() for r in reads])
    want = jax_assemble(mat, lens, params, seed=seed)
    got = assemble_reads(mat, lens, params, seed=seed, device="cpu")
    assert canonical_set(got) == jax_canonical_set(want)
    assert got == want          # headers, attrs and row order too
    assert len(got) >= 2


def _write_fastq(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def test_cli_run_writes_reference_layout(tmp_path):
    reads, params, seed = _case_600bp()
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, reads)
    out = str(tmp_path / "asm")
    assert cli.main(["run", "-fastq", fq, "-kmer", "21", "-cover", "2",
                     "-mincontig", "300", "-seed", str(seed),
                     "-outfile", out, "-device", "cpu"]) == 0
    for name in ("part-00000", "_SUCCESS", "assembly_report.txt",
                 "metrics.json"):
        assert os.path.exists(os.path.join(out, name)), name
    mat, lens = jio.reads_to_matrix([r.encode() for r in reads])
    want = jax_assemble(mat, lens, params, seed=seed)
    jax_out = tmp_path / "jax"
    jio.write_contigs_fasta(str(jax_out / "part-00000"), want)
    jax_report(str(jax_out / "assembly_report.txt"), want)
    for name in ("part-00000", "assembly_report.txt"):
        with open(os.path.join(out, name)) as a, open(jax_out / name) as b:
            assert a.read() == b.read(), name


def test_cli_counter_then_run_from_kmerc(tmp_path):
    reads, params, seed = _case_600bp()
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, reads)
    cnt = str(tmp_path / "cnt")
    assert cli.main(["counter", "-fastq", fq, "-kmer", "21", "-cover", "2",
                     "-outfile", cnt, "-device", "cpu"]) == 0
    table = os.path.join(cnt, "Count_21")
    assert os.path.exists(os.path.join(table, "_SUCCESS"))
    out = str(tmp_path / "asm")
    assert cli.main(["run", "-kmerc", table, "-kmer", "21", "-cover", "2",
                     "-mincontig", "300", "-seed", str(seed),
                     "-outfile", out, "-device", "cpu"]) == 0
    mat, lens = jio.reads_to_matrix([r.encode() for r in reads])
    want = jax_assemble(mat, lens, params, seed=seed)
    got = iter_fasta([os.path.join(out, "part-00000")])
    assert {s.decode() for _, s in got} == {s for _, s in want}


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["counter", "-fastq", "x.fq", "-outfile", str(tmp_path)])


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import with jax and
    the JAX package blocked."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['reflexiv_tpu'] = None\n"
        "import reflexiv_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'reflexiv_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert {'reflexiv_tpu_torch.' + m for m in ('preprocess', "
        "'merger', 'stitch', 'chains', 'parallel')} <= set(names), names\n"
        "import chip_smoke\n"
        "assert not any(m.startswith('reflexiv_tpu.') for m in sys.modules),"
        " 'JAX package imported'\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
