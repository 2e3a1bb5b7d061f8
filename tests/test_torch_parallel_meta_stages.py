"""Parity of the port's ``meta`` stages on a mesh with the JAX package's
(the other half of ``test_torch_parallel_meta.py``, whose helpers and
``jx`` fixture it shares): the JAX side on the 8 virtual CPU devices of
``tests/conftest.py``, the port on ``make_mesh(["cpu"] * 8)``. Exact:
``assemble_dynamic`` with its stage pools row for row and both packages
resuming from the port's flat stage 02 pool, dense fixing, the
``dryrun_multichip`` meta chain, and the CLI's files byte for byte."""
import torch_threads  # noqa: F401
import os
import shutil

import numpy as np
import pytest

from reflexiv_tpu_torch import checkpoint as tckpt
from reflexiv_tpu_torch import cli, meta
from reflexiv_tpu_torch.io import reads_to_matrix
from reflexiv_tpu_torch.params import Params
from test_torch_parallel_meta import (  # noqa: F401 (jx: a fixture)
    KLIST, MESH, _byte_rows, _fastq, _frows, _jparams, _matrix, _reads, jx)


@pytest.fixture(scope="module")
def jax_meta(jx, tmp_path_factory):
    """The JAX package's mesh ``meta`` of the 800 bp case, with its stage
    checkpoints."""
    mat, lens = _matrix(_reads(41))
    kw = dict(klist=KLIST, min_kmer_coverage=2, min_contig=400,
              min_iterations=15)
    steps = tmp_path_factory.mktemp("jaxmesh") / "steps"
    want = jx.dyn.assemble_dynamic(mat, lens, jx.Params(**kw), seed=0,
                                   workdir=str(steps), mesh=jx.mesh)
    return mat, lens, Params(**kw), want, str(steps)


def test_assemble_dynamic_mesh_matches_jax(jx, jax_meta, tmp_path):
    """The 800 bp case: the contig list, and stage 00's records and the
    02/03 pools row for row."""
    mat, lens, params, want, jsteps = jax_meta
    steps = str(tmp_path / "steps")
    got = meta.assemble_dynamic(mat, lens, params, seed=0, device="cpu",
                                workdir=steps, mesh=MESH)
    assert got == want and len(got) >= 1
    for stage in ("00sorted", "01reduced", "02extended", "03fixed"):
        assert _byte_rows(jx.ckpt.load_records(steps, stage)) == \
            _byte_rows(jx.ckpt.load_records(jsteps, stage)), stage
    # both packages resume from the port's flat stage 02 pool
    for stage in ("04contigs", "03fixed"):
        shutil.rmtree(os.path.join(steps, stage))
    jcopy = str(tmp_path / "jsteps")
    shutil.copytree(steps, jcopy)
    assert meta.assemble_dynamic(mat, lens, params, seed=0, device="cpu",
                                 workdir=steps, mesh=MESH) == want
    assert jx.dyn.assemble_dynamic(mat, lens, _jparams(jx, params), seed=0,
                                   workdir=jcopy, mesh=jx.mesh) == want


@pytest.mark.parametrize("fast", [False, True])
def test_dense_fixing_on_mesh_matches_jax(jx, jax_meta, fast):
    """Dense fixing over the JAX run's stage 02 pool: the faithful form
    (kmax = 41) and the unique-overlap form (as for kmax < 32, kfix =
    21)."""
    _mat, _lens, params, _want, jsteps = jax_meta
    jpool = jx.ckpt.load_records(jsteps, "02extended")
    flat = tckpt.load_records(jsteps, "02extended", flat=True)
    jparams = _jparams(jx, params)
    if fast:
        want = jx.dyn.fixing_rounds(jpool, jparams, kfix=21, seed=1000,
                                    mesh=jx.mesh)
        got = meta.fixing_rounds_mesh(flat, params, kfix=21, seed=1000,
                                      mesh=MESH)
    else:
        want = jx.dyn.fixing_rounds_faithful(jpool, jparams, kmax=41,
                                             seed=1000, mesh=jx.mesh)
        got = meta.fixing_rounds_faithful(flat, params, kmax=41,
                                          seed=1000, mesh=MESH)
    assert _frows(got) == _byte_rows(want)


def test_dryrun_meta_chain_matches_jax(jx):
    """``__graft_entry__.dryrun_multichip``'s meta chain: 400 reads of 60 bp
    from a 600 bp genome, klist (15, 21, 33), ``-accurate``."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 600, dtype=np.uint8)
    reads = []
    for _ in range(400):
        s = int(rng.integers(0, len(genome) - 60))
        r = genome[s:s + 60]
        if rng.random() < 0.5:
            r = r[::-1] ^ 3
        reads.append(np.frombuffer(b"ACGT", np.uint8)[r].tobytes())
    mat, lens = reads_to_matrix(reads)
    kw = dict(klist=(15, 21, 33), min_kmer_coverage=2, min_contig=200,
              sensitive=True)
    want = jx.dyn.assemble_dynamic(mat, lens, jx.Params(**kw), seed=0,
                                   mesh=jx.mesh)
    got = meta.assemble_dynamic(mat, lens, Params(**kw), seed=0,
                                device="cpu", mesh=MESH)
    assert got == want
    assert max(len(s) for _, s in got) >= 400


@pytest.mark.parametrize("case", ["reads", "reduce_first", "budget"])
def test_cli_meta_on_a_mesh_matches_jax_cli(jx, jax_meta, tmp_path,
                                            monkeypatch, case):
    """``meta`` straight from the reads, after ``reduce`` into the same
    -outfile, and under ``REFLEXIV_INGEST_BUDGET_MB`` (which a mesh
    ignores in stage 00, as the JAX package's does): the JAX CLI meshes
    over all 8 devices, the port's ``cmd_meta`` over ``make_mesh(["cpu"] *
    8)``; ``Assembly/part-00000`` and ``assembly_report.txt`` byte for
    byte."""
    if case == "budget":
        monkeypatch.setenv("REFLEXIV_INGEST_BUDGET_MB", "1")
    fq = tmp_path / "reads.fq"
    _fastq(fq, _reads(41))       # jax_meta's case: its programs are built
    args = ["-fastq", str(fq), "-cover", "2", "-klist", "21,31,41",
            "-mincontig", "400", "-miniter", "15"]
    monkeypatch.setattr(cli, "_auto_mesh", lambda device: MESH)
    for pkg, main, extra in (("jax", jx.cli.main, []),
                             ("port", cli.main, ["-device", "cpu"])):
        out = ["-outfile", str(tmp_path / pkg)] + extra
        if case == "reduce_first":
            assert main(["reduce"] + args + out) == 0
        assert main(["meta"] + args + out) == 0
    for name in ("part-00000", "assembly_report.txt"):
        got = (tmp_path / "port" / "Assembly" / name).read_bytes()
        assert got == (tmp_path / "jax" / "Assembly" / name).read_bytes()
    assert (tmp_path / "port" / "Assembly" / "part-00000").stat().st_size
    import json

    met = json.loads((tmp_path / "port" / "metrics.json").read_text())
    assert met["counters"]["meta/extension_rounds"] >= 1
    # the streaming count's timer: stage 00 did not stream under the budget
    assert "count.input_stall_s" not in met["stages_s"]
