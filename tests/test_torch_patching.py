"""Parity: the port's patching against ``reflexiv_tpu.patching``.

``patch_contigs`` (contigs and link rows) on the inputs of
``tests/test_patching.py``, under each mapping backend of both packages:
the hashed native call (the default), the sorted native call, the numpy
oracle and the device form (``REFLEXIV_DEVICE_STAGES=1``; the port on the
CPU, the JAX package on its CPU backend). Also the end index, the device
map array for array, the ten mapping arrays of every form, and
``read_pairs_from_params``. Exact: integers and strings."""
import torch_threads  # noqa: F401
import random

import numpy as np
import pytest

import oracle
from reflexiv_tpu import native as jnative
from reflexiv_tpu import patching as jpatch
from reflexiv_tpu.params import Params as JParams
from reflexiv_tpu_torch import native as tnative
from reflexiv_tpu_torch import patching as tpatch
from reflexiv_tpu_torch.params import Params


def _pairs_from(genome, rng, n=80, insert=220, rl=60):
    pairs = []
    for _ in range(n):
        s = rng.randrange(len(genome) - insert)
        pairs.append((genome[s:s + rl],
                      oracle.revcomp(genome[s + insert - rl:s + insert])))
    return pairs


def _junk(rng, n, rl):
    return [("".join(rng.choice("ACGT") for _ in range(rl)),
             "".join(rng.choice("ACGT") for _ in range(rl)))
            for _ in range(n)]


def _genome(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _case(name):
    """(contigs, pairs) of tests/test_patching.py's cases."""
    if name == "overlap":          # :17, contigs overlapping by 40 bp
        rng = random.Random(5)
        g = _genome(rng, 1200)
        return [g[:640], g[600:]], _pairs_from(g, rng)
    if name == "gap":              # :30 and :64, a 40 bp gap
        rng = random.Random(6)
        g = _genome(rng, 1200)
        return [g[:580], g[620:]], _pairs_from(g, rng)
    if name == "no_pairs":         # :43
        rng = random.Random(7)
        return [_genome(rng, 600), _genome(rng, 600)], []
    if name == "reverse":          # :52, second contig on the other strand
        rng = random.Random(8)
        g = _genome(rng, 1200)
        return [g[:640], oracle.revcomp(g[600:])], _pairs_from(g, rng)
    if name == "gap_estimate":     # :82
        rng = random.Random(9)
        g = _genome(rng, 1200)
        return [g[:580], g[620:]], _pairs_from(g, rng, n=200)
    if name == "messy":            # :146, junk, N reads and an N contig
        rng = random.Random(13)
        g = _genome(rng, 5000)
        cuts = [0, 900, 1700, 2600, 3400, 4200, 5000]
        contigs = []
        for i in range(len(cuts) - 1):
            c = g[max(0, cuts[i] - 20): cuts[i + 1]]
            contigs.append(oracle.revcomp(c) if i % 2 else c)
        pairs = _pairs_from(g, rng, n=600, insert=260, rl=70) + \
            _junk(rng, 60, 70)
        pairs.append(("N" * 70, "N" * 70))
        pairs.append(("T" * 70, "T" * 35 + "N" + "T" * 34))
        contigs.append(contigs[0][:200] + "N" * 20 + contigs[1][:200])
        return contigs, pairs
    if name == "8kb":              # :181, the device-parity case
        rng = random.Random(29)
        g = _genome(rng, 8000)
        cuts = [0, 1500, 3200, 4700, 6300, 8000]
        contigs = []
        for i in range(len(cuts) - 1):
            c = g[max(0, cuts[i] - 15): cuts[i + 1]]
            contigs.append(oracle.revcomp(c) if i % 2 else c)
        return contigs, _pairs_from(g, rng, n=1500, insert=280, rl=80) + \
            _junk(rng, 50, 80)
    raise KeyError(name)


CASES = ["overlap", "gap", "no_pairs", "reverse", "gap_estimate", "messy",
         "8kb"]
BACKENDS = ["hashed_native", "sorted_native", "numpy", "device"]


def _backend(monkeypatch, backend):
    monkeypatch.delenv("REFLEXIV_DEVICE_STAGES", raising=False)
    monkeypatch.delenv("REFLEXIV_NATIVE_PATCH", raising=False)
    if backend == "sorted_native":
        monkeypatch.setattr(tnative, "map_pairs_hashed_native",
                            lambda *a, **kw: None)
        monkeypatch.setattr(jnative, "map_pairs_hashed_native",
                            lambda *a, **kw: None)
    elif backend == "numpy":
        monkeypatch.setenv("REFLEXIV_NATIVE_PATCH", "0")
    elif backend == "device":
        monkeypatch.setenv("REFLEXIV_DEVICE_STAGES", "1")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_patch_contigs_matches_jax(monkeypatch, case, backend):
    if backend != "numpy" and tnative._get_lib() is None:
        pytest.skip("native library unavailable")
    contigs, pairs = _case(case)
    _backend(monkeypatch, backend)
    for scaffold in (False, True):
        want = jpatch.patch_contigs(contigs, pairs, scaffold=scaffold)
        got = tpatch.patch_contigs(contigs, pairs, scaffold=scaffold,
                                   device="cpu")
        assert got == want, (case, backend, scaffold)
    if case != "no_pairs":
        assert len(want[1]) >= 1      # the case links contigs


def _end_index_contigs():
    """tests/test_patching.py:246's contigs: shared ends, a lowercase
    contig, contigs shorter than the window set and than k, an N run, an
    exact duplicate (ambiguous keys) and a reverse complement."""
    rng = random.Random(37)
    g = _genome(rng, 6000)
    return [g[:700], g[650:1500], g[1400:2500].lower(), g[:40], g[:20],
            g[2400:3000] + "N" * 15 + g[3100:3600], g[:700],
            oracle.revcomp(g[3500:4400])]


@pytest.mark.parametrize("native_on", ["1", "0"])
def test_end_index_matches_jax(monkeypatch, native_on):
    if native_on == "1" and tnative._get_lib() is None:
        pytest.skip("native library unavailable")
    contigs = _end_index_contigs()
    monkeypatch.delenv("REFLEXIV_DEVICE_STAGES", raising=False)
    monkeypatch.setenv("REFLEXIV_NATIVE_PATCH", native_on)
    got = tpatch._end_index_arrays(contigs)
    monkeypatch.setenv("REFLEXIV_NATIVE_PATCH", "0")
    want = jpatch._end_index_arrays(contigs)
    for name in ("keys", "ci", "end", "pos", "strand"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert len(got.keys) > 100
    # lowercase bases index as their uppercase
    up = tpatch._end_index_arrays([s.upper() for s in contigs])
    np.testing.assert_array_equal(up.keys, got.keys)


def _mate_matrices(pairs, mate):
    a, lens = tpatch._ascii_matrix([p[mate] for p in pairs])
    m = tpatch.encode_ascii(a)
    if mate == 0:
        return m, lens, tpatch._window_acgt_ok(a, tpatch.SEED_K)
    col = lens[:, None].astype(np.int64) - 1 - np.arange(a.shape[1])
    ar = np.where(col >= 0, a[np.arange(len(lens))[:, None],
                              np.clip(col, 0, None)], 0).astype(np.uint8)
    return (tpatch.revcomp_matrix(m, lens), lens,
            tpatch._window_acgt_ok(ar, tpatch.SEED_K))


@pytest.mark.parametrize("case", ["8kb", "messy"])
def test_device_map_matches_jax_device_map(monkeypatch, case):
    """The port's device form on the CPU against the JAX package's jitted
    ``_map_reads_arrays_device``, both mates, array for array."""
    monkeypatch.setenv("REFLEXIV_NATIVE_PATCH", "0")
    contigs, pairs = _case(case)
    idx = tpatch._end_index_arrays(contigs)
    jidx = jpatch._end_index_arrays(contigs)
    for mate in (0, 1):
        m, lens, ok = _mate_matrices(pairs, mate)
        got = tpatch._map_reads_arrays_device(m, lens, idx, acgt_ok=ok,
                                              device="cpu")
        want = jpatch._map_reads_arrays_device(m, lens, jidx, acgt_ok=ok)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        assert got[4].sum() > 100


@pytest.mark.parametrize("form", ["sorted_native", "numpy", "device"])
def test_map_pairs_forms_equal_the_hashed_native(monkeypatch, form):
    """tests/test_patching.py:286's case (duplicate ends, an N run, a
    contig shorter than k, an N read): every form's ten arrays equal the
    hashed native call's, and the JAX package's native calls'."""
    if tnative._get_lib() is None:
        pytest.skip("native library unavailable")
    rng = random.Random(53)
    g = _genome(rng, 9000)
    contigs = [g[:800], g[750:1600], g[:800], oracle.revcomp(g[1500:2400]),
               g[2300:2800] + "N" * 12 + g[2900:3400], g[:25]]
    pairs = _pairs_from(g, rng, n=1200, insert=260, rl=76)
    pairs.append(("N" * 76, "T" * 76))
    monkeypatch.delenv("REFLEXIV_DEVICE_STAGES", raising=False)
    monkeypatch.delenv("REFLEXIV_NATIVE_PATCH", raising=False)
    want, len2 = tpatch.map_pairs(contigs, pairs, device="cpu")
    jwant = jnative.map_pairs_hashed_native(
        contigs, pairs, k=31, end_window=300, stride=7)
    _backend(monkeypatch, form)
    got, glen2 = tpatch.map_pairs(contigs, pairs, device="cpu")
    for g_, w, jw in zip(got, want, jwant):
        np.testing.assert_array_equal(g_, w)
        np.testing.assert_array_equal(w, jw)
        assert g_.dtype == w.dtype == jw.dtype
    np.testing.assert_array_equal(glen2, len2)
    assert want[4].sum() > 100


def test_best_overlap_native_matches_the_scan():
    if tnative._get_lib() is None:
        pytest.skip("native library unavailable")
    rng = random.Random(3)
    for _ in range(50):
        a = _genome(rng, rng.randrange(5, 60))
        o = rng.randrange(0, len(a))
        b = a[len(a) - o:] + _genome(rng, rng.randrange(0, 40))
        want = jnative.best_overlap_native(a.encode(), b.encode(), 3)
        assert tnative.best_overlap_native(a.encode(), b.encode(), 3) == want


def _write_fq(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


@pytest.mark.parametrize("layout", ["two_files", "interleaved", "single",
                                    "unequal"])
def test_read_pairs_from_params_matches_jax(tmp_path, layout):
    """tests/test_patching.py:94's cases, and two files of unequal
    length (unpaired)."""
    _write_fq(tmp_path / "m1.fq", ["ACGTACGT", "GGGGCCCC"])
    _write_fq(tmp_path / "m2.fq", ["TTTTAAAA", "CACACACA"])
    _write_fq(tmp_path / "m3.fq", ["TTTTAAAA"])
    _write_fq(tmp_path / "il.fq",
              ["ACGTACGT", "TTTTAAAA", "GGGGCCCC", "CACACACA"])
    kw = {"two_files": dict(input_fastq=f"{tmp_path}/m1.fq,{tmp_path}/m2.fq"),
          "interleaved": dict(input_fastq=str(tmp_path / "il.fq"),
                              interleaved=True),
          "single": dict(input_fastq=str(tmp_path / "il.fq")),
          "unequal": dict(
              input_fastq=f"{tmp_path}/m1.fq,{tmp_path}/m3.fq")}[layout]
    want = jpatch.read_pairs_from_params(JParams(**kw))
    assert tpatch.read_pairs_from_params(Params(**kw)) == want
    assert bool(want) == (layout in ("two_files", "interleaved"))


def test_apply_patching_matches_jax(tmp_path):
    """tests/test_patching.py:122: two FASTQ mates, scaffolded."""
    contigs, pairs = _case("gap")
    with open(tmp_path / "m1.fq", "w") as f1, \
            open(tmp_path / "m2.fq", "w") as f2:
        for i, (r1, r2) in enumerate(pairs):
            f1.write(f"@p{i}/1\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@p{i}/2\n{r2}\n+\n{'I' * len(r2)}\n")
    kw = dict(input_fastq=f"{tmp_path}/m1.fq,{tmp_path}/m2.fq", patch=True,
              scaffold=True)
    headed = [(f">Contig-{len(s)}-(0,0)-{i}", s)
              for i, s in enumerate(contigs)]
    want = jpatch.apply_patching(headed, JParams(**kw))
    got = tpatch.apply_patching(headed, Params(**kw), device="cpu")
    assert got == want
    assert len(got[0]) == 1 and "N" in got[0][0][1]


# ---------------------------------------------------------------------------
# meta -patch / -scaffold through both CLIs
# ---------------------------------------------------------------------------

THIN, GAP = (1500, 1530), (3200, 3260)


def paired_library(seed=11, genome_bp=5000, n_pairs=500, rl=100, insert=300,
                   sd=30, err=0.004):
    """A 5 kb genome read as 100 bp pairs of 300 +- 30 bp fragments with
    0.4% substitutions, each pair in a random mate order. No read touches
    the 30 bp stretch ``THIN`` or the 60 bp gap ``GAP``, but pairs span
    both; reads end right at both sides of ``THIN`` (solid margins, as
    tests/test_e2e.py:204 builds them) and one error-free pair covers it,
    so ``-accurate`` bridges it and ``-patch`` links across ``GAP``."""
    rng = random.Random(seed)
    g = _genome(rng, genome_bp)

    def noisy(s):
        return "".join(c if rng.random() > err else rng.choice("ACGT")
                       for c in s)

    def pair(s, ins):
        return (g[s:s + rl], oracle.revcomp(g[s + ins - rl:s + ins]))

    pairs = []
    while len(pairs) < n_pairs:
        ins = max(2 * rl, int(rng.gauss(insert, sd)))
        s = rng.randrange(0, genome_bp - ins + 1)
        spans = ((s, s + rl), (s + ins - rl, s + ins))
        if any(lo < b and a < hi for a, b in spans
               for lo, hi in (THIN, GAP)):
            continue
        m1, m2 = noisy(g[s:s + rl]), noisy(g[s + ins - rl:s + ins])
        m2 = oracle.revcomp(m2)
        pairs.append((m2, m1) if rng.random() < 0.5 else (m1, m2))
    for off in (0, 3, 6, 9):
        pairs.append(pair(THIN[0] - rl - off, insert))
        pairs.append(pair(THIN[1] + off, insert))
    pairs.append(pair((THIN[0] + THIN[1] - rl) // 2, insert))
    return g, pairs


def write_paired(directory, pairs):
    """Mate 1 and mate 2 FASTQ files; returns the ``-paired`` argument."""
    paths = [str(directory / f"m{j + 1}.fq") for j in range(2)]
    for j, path in enumerate(paths):
        _write_fq(path, [p[j] for p in pairs])
    return ",".join(paths)


META_ARGS = ["-cover", "2", "-klist", "21,31,41", "-mincontig", "300"]


def run_both(argv, out_root, monkeypatch):
    """``argv + -outfile <out_root>/<pkg>`` through both CLIs; the JAX CLI
    sees one device, as on a one-chip host."""
    import jax

    from reflexiv_tpu.cli import main as jax_main
    from reflexiv_tpu_torch import cli

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    assert jax_main(argv + ["-outfile", str(out_root / "jax")]) == 0
    assert cli.main(argv + ["-outfile", str(out_root / "port"),
                            "-device", "cpu"]) == 0
    monkeypatch.undo()


def _patch_outputs(root):
    out = {}
    for rel in ("Assembly/part-00000", "04Patching/links.tsv"):
        path = root / rel
        out[rel] = path.read_bytes() if path.exists() else None
    return out


@pytest.fixture(scope="module")
def meta_patch_runs(tmp_path_factory):
    """``meta -patch``, then ``meta -patch -scaffold`` into the same
    directories (it resumes from ``steps/04contigs`` and patches again),
    through both CLIs."""
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("meta_patch")
    _g, pairs = paired_library()
    argv = ["meta", "-paired", write_paired(d, pairs)] + META_ARGS
    runs = {}
    for flags in (["-patch"], ["-patch", "-scaffold"]):
        run_both(argv + flags, d, mp)
        runs[" ".join(flags)] = {pkg: _patch_outputs(d / pkg)
                                 for pkg in ("jax", "port")}
    return runs


@pytest.mark.parametrize("flags", ["-patch", "-patch -scaffold"])
def test_cli_meta_patch_matches_jax(meta_patch_runs, flags):
    got, want = meta_patch_runs[flags]["port"], meta_patch_runs[flags]["jax"]
    assert got == want
    links = want["04Patching/links.tsv"].decode().splitlines()
    assert links[0] == "contig_a\tend_a\tcontig_b\tend_b\tn_links\tgap"
    assert len(links) >= 2
    assert (b"N" in want["Assembly/part-00000"]) == ("-scaffold" in flags)
