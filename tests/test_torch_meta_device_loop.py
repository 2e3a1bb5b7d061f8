"""Parity: the port's one-card ``meta`` loop against the JAX package's
default off the TPU (``REFLEXIV_INDEXED_ALWAYS`` unset): the device-pool
loop for stage 02 and the fast fixing, one summary-indexed round then the
device loop for the faithful fixing passes, the handoff of a pool over
``REFLEXIV_BUCKET_ROUND_ROWS``, parking on the JAX pool's capacity, loop
checkpoints resumed across the packages, and the CLI. The same seeded
inputs go through both packages; exact throughout: contig lists, headers
and order included, and the stage files byte for byte."""
import torch_threads  # noqa: F401
import logging
import os
import re
import shutil

import numpy as np
import pytest

import jax
from reflexiv_tpu import checkpoint as jckpt
from reflexiv_tpu import dynamic as jdyn
from reflexiv_tpu import packed_dyn as jpd
from reflexiv_tpu.params import Params as JParams
from reflexiv_tpu_torch import checkpoint as tckpt
from reflexiv_tpu_torch import cli, dyn_pool, meta, metrics
from reflexiv_tpu_torch import packed_dyn as pd
from reflexiv_tpu_torch.dyn_pool import DynRecords
from reflexiv_tpu_torch.params import Params
from test_torch_meta import _case, _fastq, _reads
from test_torch_mercy import _tree

LOOP_VARS = ("REFLEXIV_INDEXED_ALWAYS", "REFLEXIV_BUCKET_ROUND_ROWS",
             "REFLEXIV_CKPT_EVERY_S", "REFLEXIV_FAST_FIXING",
             "REFLEXIV_SKIP_EXTEND_PASS")
STAGES = ("02extended", "03fixed", "04contigs")
BUCKETED = re.compile(r"bucketed round \d+: \d+ live rows")


@pytest.fixture(autouse=True)
def _default_loop(monkeypatch):
    """Both packages at their off-TPU defaults."""
    for var in LOOP_VARS:
        monkeypatch.delenv(var, raising=False)


class _Lines(logging.Handler):
    """Both packages' log lines, in order."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        for name in ("reflexiv_tpu", "reflexiv_tpu_torch"):
            lg = logging.getLogger(name)
            lg.addHandler(self)
            self.levels = getattr(self, "levels", []) + [lg.level]
            lg.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        for name, level in zip(("reflexiv_tpu", "reflexiv_tpu_torch"),
                               self.levels):
            logging.getLogger(name).removeHandler(self)
            logging.getLogger(name).setLevel(level)

    def take(self, pattern=BUCKETED):
        out = [s for s in self.lines if pattern.search(s)]
        self.lines = []
        return out


def _both(tmp, case, env=(), dense16=False):
    """One case through both packages' ``assemble_dynamic`` with stage
    checkpoints: the contig lists, the stage trees, the "bucketed round"
    lines and the port's metrics."""
    mp = pytest.MonkeyPatch()
    for var in LOOP_VARS:
        mp.delenv(var, raising=False)
    for var, value in env:
        mp.setenv(var, value)
    if dense16:
        mp.setattr(jdyn._RaggedPool, "W_DENSE", 16)
        mp.setattr(dyn_pool.RaggedPool, "W_DENSE", 16)
    mat, lens, jparams, params = _case(case)
    out = {}
    with _Lines() as lines:
        want = jdyn.assemble_dynamic(mat, lens, jparams, seed=1,
                                     workdir=str(tmp / "jax"))
        out["jax_lines"] = lines.take()
        met = metrics.reset()
        got = meta.assemble_dynamic(mat, lens, params, seed=1, device="cpu",
                                    workdir=str(tmp / "port"))
        out["port_lines"] = lines.take()
    mp.undo()
    return dict(out, want=want, got=got, counts=dict(met.counts),
                jax=_tree(tmp / "jax"), port=_tree(tmp / "port"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 3 kb case (faithful fixing; the dense width shrunk to 256 bases
    in both packages, so the loop's long rows leave it) and the 500 bp
    case (the fast fixing), both at the defaults; and the 3 kb case with
    ``REFLEXIV_BUCKET_ROUND_ROWS=64`` (``tests/test_dynamic.py``'s
    handoff)."""
    return {
        "3kb": _both(tmp_path_factory.mktemp("d3kb"), "3kb", dense16=True),
        "500bp": _both(tmp_path_factory.mktemp("d500"), "500bp"),
        "handoff": _both(tmp_path_factory.mktemp("hand"), "3kb",
                         env=[("REFLEXIV_BUCKET_ROUND_ROWS", "64")]),
    }


def _stage_files(tree):
    return {rel: b for rel, b in tree.items() if rel.startswith(STAGES)}


@pytest.mark.parametrize("case", ["3kb", "500bp", "handoff"])
def test_assembly_and_stage_files_match_unpinned_jax(runs, case):
    r = runs[case]
    assert r["got"] == r["want"] and r["got"]
    files = _stage_files(r["port"])
    assert files == _stage_files(r["jax"])
    assert {rel.split("/")[0] for rel in files} == set(STAGES)
    assert r["port_lines"] == r["jax_lines"]
    c = r["counts"]
    assert c["meta/rounds"] == c["meta/rounds_device"] \
        + c.get("meta/rounds_indexed", 0)
    if case == "500bp":
        # the device loop in stage 02 and in both fast fixing passes
        assert "meta/rounds_indexed" not in c and not r["port_lines"]
    elif case == "3kb":
        # one indexed round in each of the four faithful fixing passes
        assert len(r["port_lines"]) == c["meta/rounds_indexed"] == 4
        assert all(s.startswith("bucketed round 1:")
                   for s in r["port_lines"])
    else:
        # stage 02 ran indexed rounds until at most 64 rows were live, then
        # handed the pool to the device loop; each fixing pass runs one
        its, lives = zip(*(map(int, re.findall(r"(\d+): (\d+)", s)[0])
                           for s in r["port_lines"]))
        m = its.index(1, 1)
        assert its[:m] == tuple(range(1, m + 1)) and m > 1
        assert min(lives[:m - 1]) > 64 >= lives[m - 1]
        assert c["meta/extension_rounds"] > m
        assert c["meta/rounds_indexed"] == m + 4
        assert max(len(s) for _h, s in r["got"]) > 2500


PARKING = {
    # on the JAX pool's 2100 rows the 350 isolated rows pass max(32,
    # 2100 / 8) at round 8 and park; on 4096 rows they would not
    "capacity": (726, 350),
    # 291 of 1184 rows live before round 8: the pool compacts to 512 rows,
    # and the 100 isolated rows pass max(32, 512 / 8) (not 1184 / 8)
    "compaction": (60, 100),
}


def _parking_pool(n_stuck, n_iso, pad_to=None, k=21):
    """``n_stuck`` rows of an overlap chain whose joins the merge gate
    blocks (left -3, right 0: never finished, never merged), a 1024-row
    chain that merges, and ``n_iso`` isolated rows, finished from round 1;
    dead rows up to ``pad_to``."""
    rng = np.random.default_rng(5)
    n_chain = 1024
    n = n_stuck + n_chain + n_iso
    N = pad_to or n
    seq = np.zeros((N, 64), np.uint8)
    length = np.zeros(N, np.int32)
    right = np.full(N, -3, np.int32)
    at = 0
    for m, r in ((n_stuck, 0), (n_chain, -3)):
        g = rng.integers(0, 4, m + k - 1, dtype=np.uint8)
        for i in range(m):
            seq[at + i, :k] = g[i:i + k]
        length[at:at + m], right[at:at + m] = k, r
        at += m
    seq[at:n, :2 * k] = rng.integers(0, 4, size=(n_iso, 2 * k))
    length[at:n] = 2 * k
    live = np.arange(N) < n
    subk = np.where(live, k - 1, 1).astype(np.int32)
    return DynRecords(seq, length, subk, np.full(N, -3, np.int32), right,
                      live)


def _park_rounds(monkeypatch, module):
    """Record the round on which ``module.park_finished_pdyn`` runs."""
    rounds, parks = [0], []
    real_round = module.pdyn_extension_round_fused
    real_park = module.park_finished_pdyn

    def round_(*a, **kw):
        rounds[0] += 1
        return real_round(*a, **kw)

    def park(*a):
        parks.append(rounds[0])
        return real_park(*a)

    monkeypatch.setattr(module, "pdyn_extension_round_fused", round_)
    monkeypatch.setattr(module, "park_finished_pdyn", park)
    return parks


def _rows(seq, length, subk, left, right, live):
    """Live rows of a packed pool in order, with the pool's width."""
    seq, length = np.asarray(seq), np.asarray(length)
    idx = np.nonzero(np.asarray(live))[0]
    bases = dyn_pool.unpack_seq_matrix_np(seq[idx], seq.shape[1] * 16)
    return seq.shape[1], [
        (b[:n].tobytes(), int(s), int(lf), int(rt)) for b, n, s, lf, rt in
        zip(bases, length[idx], np.asarray(subk)[idx],
            np.asarray(left)[idx], np.asarray(right)[idx])]


@pytest.mark.parametrize("case", list(PARKING))
def test_parking_matches_jax_on_its_capacity(monkeypatch, case):
    """The forced parking cases through both packages' loops
    (``return_packed``): the same parking round, rows and width."""
    recs = _parking_pool(*PARKING[case])
    params = dict(k=21, min_iterations=15)
    jparks = _park_rounds(monkeypatch, jpd)
    want = _rows(*jdyn.run_dyn_extension(
        jdyn.DynRecords(*recs), JParams(**params), kmin=21, kmax=21,
        return_packed=True))
    parks = _park_rounds(monkeypatch, pd)
    got = _rows(*meta.run_dyn_extension(recs, Params(**params), kmin=21,
                                        device="cpu"))
    assert jparks == parks and parks[0] == 8
    assert got == want
    if case == "capacity":
        # the pool's dead rows count: padded, it would not park at round 8
        parks.clear()
        meta.run_dyn_extension(_parking_pool(*PARKING[case], pad_to=4096),
                               Params(**params), kmin=21, device="cpu")
        assert parks[:1] != [8]


def test_stage02_pool_matches_jax():
    """``records_from_sorted`` as the JAX pool once packed: its rows, dead
    ones too, which are the device loop's capacity."""
    rng = np.random.default_rng(2)
    sets = [(rng.integers(0, 4, (n, k), dtype=np.uint8),
             rng.integers(-3, 9, n).astype(np.int32),
             rng.integers(-3, 9, n).astype(np.int32), k)
            for n, k in ((100, 23), (37, 31), (55, 41))]
    want = jpd.from_dyn_host(jdyn.records_from_sorted(sets))
    got = meta.records_from_sorted(sets)
    assert got.capacity == 256
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _groups_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("start", ["pool", "groups"])
def test_loop_checkpoint_resumes_across_packages(runs, tmp_path, monkeypatch,
                                                 writer, start):
    """A loop stopped after round 5 of a stage 02 pool (device-loop state)
    or after round 1 of width-class groups (the indexed round's ragged
    state) with ``REFLEXIV_CKPT_EVERY_S=0``: both packages save the same
    state, and the other package resumes the writer's to what the writer's
    own package gives from it."""
    monkeypatch.setenv("REFLEXIV_CKPT_EVERY_S", "0")
    monkeypatch.setattr(jdyn._RaggedPool, "W_DENSE", 16)
    monkeypatch.setattr(dyn_pool.RaggedPool, "W_DENSE", 16)
    src = tmp_path / "src"
    for rel, data in runs["3kb"]["jax"].items():
        if rel.startswith(("01reduced", "02extended")):
            (src / os.path.dirname(rel)).mkdir(parents=True, exist_ok=True)
            (src / rel).write_bytes(data)
    _m, _l, jparams, params = _case("3kb")
    if start == "pool":
        jrecs = jckpt.load_records(str(src), "01reduced")
        recs = tckpt.load_records(str(src), "01reduced")
        kw, stop = dict(kmin=23, seed=1), 5
    else:
        jrecs = jckpt.load_records(str(src), "02extended")
        recs = tckpt.load_records(str(src), "02extended")
        kw, stop = dict(kmin=31, seed=1000), 1

    def jax_loop(d, **more):
        return jdyn.run_dyn_extension(jrecs, jparams, kmax=kw["kmin"],
                                      return_groups=True, ckpt_dir=d,
                                      **kw, **more)

    def port_loop(d, **more):
        return meta.run_dyn_extension(recs, params, device="cpu",
                                      return_groups=True, ckpt_dir=d,
                                      **kw, **more)

    loops = {"jax": jax_loop, "port": port_loop}
    other = "port" if writer == "jax" else "jax"
    dirs = {pkg: str(tmp_path / pkg) for pkg in loops}
    for pkg, loop in loops.items():
        loop(dirs[pkg], max_rounds=stop)
        assert os.path.exists(os.path.join(dirs[pkg], f"it_{stop:05d}",
                                           "_SUCCESS"))
    # the same state, as the JAX reader sees it: pool (its width too),
    # parked batches and counters
    states = [jckpt.load_loop_state(dirs[pkg]) for pkg in (writer, other)]
    assert states[0][2] == states[1][2]
    for part in (0, 1):
        a, b = (st[part] for st in states)
        _groups_equal(a if isinstance(a, list) else [a],
                      b if isinstance(b, list) else [b])
    d = dirs[writer]
    shutil.copytree(d, d + "_other")
    with _Lines() as lines:
        want = loops[writer](d)
        assert f"extension loop: resuming at round {stop + 1}" in \
            " ".join(lines.lines)
        lines.lines = []
        got = loops[other](d + "_other")
        assert f"extension loop: resuming at round {stop + 1}" in \
            " ".join(lines.lines)
    _groups_equal(got, want)


def test_cli_reduce_then_meta_matches_unpinned_jax(tmp_path, monkeypatch):
    """``reduce`` then ``meta`` into one -outfile through both CLIs, the
    JAX CLI on one device: every file byte for byte."""
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
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    assert "steps/02extended/meta.json" in got
    assert len(got["Assembly/part-00000"]) > 1000


def test_loop_form_follows_the_variables(monkeypatch):
    """Port only: unset runs the device form (fresh groups: one indexed
    round first), ``REFLEXIV_INDEXED_ALWAYS=1`` the indexed form; both
    give the parking case's rows."""
    params = Params(k=21, min_iterations=15)
    recs = _parking_pool(*PARKING["capacity"])
    counts = {}
    for always in (None, "1"):
        if always:
            monkeypatch.setenv("REFLEXIV_INDEXED_ALWAYS", always)
        for name, pool in (("pool", recs),
                           ("groups", [tuple(a[recs.live] for a in
                                             dyn_pool.from_dyn_host(recs)[:5])
                                       ])):
            m = metrics.reset()
            meta.run_dyn_extension(pool, params, kmin=21, device="cpu")
            counts[always, name] = (m.counts.get("meta/rounds_indexed", 0),
                                    m.counts.get("meta/rounds_device", 0))
    assert counts[None, "pool"][0] == 0 and counts[None, "pool"][1] > 8
    assert counts[None, "groups"][0] == 1 and counts[None, "groups"][1] > 8
    for name in ("pool", "groups"):
        assert counts["1", name][0] > 8 and counts["1", name][1] == 0


def test_faithful_fixing_needs_a_device():
    """Without a mesh, no device is an error, not the CPU."""
    groups = meta.groups_from_contig_rows(
        [(np.zeros(100, np.uint8), 30, -1, -1)])
    with pytest.raises(ValueError, match="device"):
        meta.fixing_rounds_faithful(groups, Params(), kmax=41)
