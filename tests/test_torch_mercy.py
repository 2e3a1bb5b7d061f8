"""Parity: the port's mercy k-mers against ``reflexiv_tpu.mercy``.

``mercy_kmer_table`` row for row (the JAX limbs through
``bitpack.limbs_from_keys``) at k = 21, 31 and 41, in one pass and in
read-row blocks, and on the cases of ``tests/test_subsystems.py``; then
``reduce -accurate``, ``mercy`` and ``meta -accurate`` through both CLIs,
file for file, byte for byte. Exact: integer tables and text."""
import torch_threads  # noqa: F401
import os
import random

import numpy as np
import pytest
import torch

import oracle
from reflexiv_tpu import mercy as jmercy
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu_torch import mercy, metrics
from reflexiv_tpu_torch.bitpack import limbs_from_keys
from test_torch_patching import META_ARGS, paired_library, run_both, \
    write_paired


def _thin_stretch_reads(seed=21, genome_bp=3000, n_reads=450, err=0.006):
    """100 bp reads from both strands with substitutions, none over the 30
    bp stretch [1500, 1530) but one error-free read across it: errors give
    weak windows with solid flanks at every k up to 41 (a read of L bases
    has them for an error at read position p with k <= p <= L - k - 1)."""
    rng = random.Random(seed)
    g = "".join(rng.choice("ACGT") for _ in range(genome_bp))
    reads = []
    while len(reads) < n_reads:
        s = rng.randrange(genome_bp - 99)
        if s < 1530 and s + 100 > 1500:
            continue
        r = "".join(c if rng.random() > err else rng.choice("ACGT")
                    for c in g[s:s + 100])
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    reads.append(g[1465:1565])
    return reads


def _subsystems_93():
    """tests/test_subsystems.py:93: 60 bp reads on a 400 bp genome, a thin
    middle stretch and one 160 bp bridge read."""
    rng = random.Random(55)
    g = "".join(rng.choice("ACGT") for _ in range(400))
    mid = len(g) // 2
    reads = [g[s:s + 60] for s in (rng.randrange(0, mid - 60)
                                   for _ in range(150))]
    reads += [g[s:s + 60] for s in (rng.randrange(mid + 20, len(g) - 60)
                                    for _ in range(150))]
    reads.append(g[mid - 60: mid + 100])
    return reads


def _subsystems_413():
    """tests/test_subsystems.py:413: 70 bp reads at 60x from both strands
    (its ``_sim_reads``, same draws), plus one read of [200, 300)."""
    rng = random.Random(17)
    g = "".join(rng.choice("ACGT") for _ in range(500))
    reads = []
    for _ in range(60 * len(g) // 70):
        s = rng.randrange(len(g) - 70 + 1)
        r = g[s:s + 70]
        for _ in r:       # its error draw per base, at error rate 0
            rng.random()
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    reads.append(g[200:300])
    return reads


def _compare(reads, k, min_cov, block_rows=0):
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    want = jmercy.mercy_kmer_table(mat, lens, k=k, min_cov=min_cov)
    metrics.reset()
    keys, counts = mercy.mercy_kmer_table(
        mat, lens, k=k, min_cov=min_cov, block_rows=block_rows,
        device="cpu")
    got_limbs = limbs_from_keys(keys, k).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got_limbs, want[0])
    np.testing.assert_array_equal(counts.numpy(), want[1])
    rescued = metrics.current().counts[f"mercy/rescued_k{k}"]
    assert rescued == int((want[1] < min_cov).sum())
    return rescued


@pytest.mark.parametrize("block_rows", [0, 7])
@pytest.mark.parametrize("k", [21, 31, 41])
def test_mercy_kmer_table_matches_jax(k, block_rows):
    assert _compare(_thin_stretch_reads(), k, 3, block_rows) > 0


def test_mercy_kmer_table_matches_jax_on_the_bridge_read_case():
    assert _compare(_subsystems_93(), 21, 2) > 0


@pytest.mark.parametrize("block_rows", [0, 7])
def test_mercy_kmer_table_matches_jax_on_the_blocked_case(block_rows):
    _compare(_subsystems_413(), 21, 3, block_rows)


def test_lookup_counts_rows_equal_keys():
    """The lexicographic row search gives the one-word search's counts
    when the rows are the keys split across two words."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(np.unique(rng.integers(0, 1 << 40, 3000)))
    counts = torch.from_numpy(rng.integers(1, 9, len(table)).astype(np.int32))
    query = torch.cat([table[rng.integers(0, len(table), 2000)],
                       torch.from_numpy(rng.integers(0, 1 << 40, 2000))])
    split = lambda t: torch.stack([t >> 20, t & ((1 << 20) - 1)], dim=1)
    c1, p1 = mercy.lookup_counts(table, counts, query)
    c2, p2 = mercy.lookup_counts(split(table), counts, split(query))
    assert torch.equal(c1, c2)
    hit = c1 > 0
    assert torch.equal(p1[hit], p2[hit])
    assert 0 < int(hit.sum()) < len(query)


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
def paired(tmp_path_factory):
    d = tmp_path_factory.mktemp("mercy_cli")
    _g, pairs = paired_library()
    return d, write_paired(d, pairs)


def test_cli_reduce_accurate_matches_jax(paired, monkeypatch):
    d, reads = paired
    root = d / "reduce"
    run_both(["reduce", "-paired", reads, "-cover", "2", "-klist",
              "23,31,41", "-accurate"], root, monkeypatch)
    want, got = _tree(root / "jax"), _tree(root / "port")
    assert set(got) == set(want) and len(want) >= 14
    for name in sorted(want):
        assert got[name] == want[name], name


def test_cli_mercy_matches_jax(paired, monkeypatch):
    d, reads = paired
    root = d / "mercy"
    run_both(["mercy", "-paired", reads, "-kmer", "21", "-cover", "3",
              "-mincontig", "300"], root, monkeypatch)
    want = (root / "jax" / "part-00000").read_bytes()
    assert (root / "port" / "part-00000").read_bytes() == want
    assert want.count(b">") >= 1
    assert (root / "port" / "_SUCCESS").exists()
    assert not (root / "port" / "assembly_report.txt").exists()


def test_cli_meta_accurate_matches_jax(paired, monkeypatch):
    """``-accurate`` bridges the 30 bp stretch that one pair covers: the
    longest contig grows past it."""
    d, reads = paired
    root = d / "meta"
    run_both(["meta", "-paired", reads, "-accurate"] + META_ARGS, root,
             monkeypatch)
    want = (root / "jax" / "Assembly" / "part-00000").read_bytes()
    assert (root / "port" / "Assembly" / "part-00000").read_bytes() == want
    longest = max(len(s.replace(b"\n", b"")) for s in
                  (c.split(b"\n", 1)[1] for c in want.split(b">")[1:]))
    assert longest > 3000
