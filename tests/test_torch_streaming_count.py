"""Parity: the port's streaming and spill counting against the JAX
package's (``reflexiv_tpu.count`` streaming functions, ``dynamic
.count_kmers_auto``), on the cases of ``tests/test_streaming_count.py`` at
k = 21, 31 and 33 (a two-word leg), the out-of-core ingest against
whole-matrix loading, and the commands under ``REFLEXIV_INGEST_BUDGET_MB``
through both CLIs. Exact: tables equal row for row once exported with
``limbs_from_keys``, files byte for byte."""
import torch_threads  # noqa: F401
import gzip
import json
import random

import numpy as np
import pytest
import torch

import oracle
from reflexiv_tpu import count as jcount
from reflexiv_tpu import dynamic as jdyn
from reflexiv_tpu import mapping as jmapping
from reflexiv_tpu import mercy as jmercy
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu_torch import count as tcount
from reflexiv_tpu_torch import io as tio
from reflexiv_tpu_torch import mapping, mercy, metrics
from reflexiv_tpu_torch.bitpack import encode_ascii, limbs_from_keys
from reflexiv_tpu_torch.params import Params
from test_torch_mercy import _tree
from test_torch_patching import run_both

KS = [21, 31, 33]


def _reads(seed, genome_bp, n_reads, lengths, err=0.0):
    """Reads of the given lengths from a random genome, both strands."""
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(genome_bp))
    reads = []
    for _ in range(n_reads):
        n = rng.choice(lengths)
        s = rng.randrange(len(genome) - n + 1)
        r = "".join(c if rng.random() >= err else rng.choice("ACGT")
                    for c in genome[s:s + n])
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return reads


def _write(path, reads, fmt="fastq"):
    """FASTQ (plain or gzip by the name) or FASTA."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n{r}\n" if fmt == "fasta" else
                     f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


def _assert_table(got, want, k):
    keys, counts = got
    wl, wc = (np.asarray(x) for x in want)
    assert keys.device.type == "cpu" and counts.dtype == torch.int32
    np.testing.assert_array_equal(
        limbs_from_keys(keys, k).numpy().astype(np.uint32).reshape(wl.shape),
        wl)
    np.testing.assert_array_equal(counts.numpy(), wc)


@pytest.mark.parametrize("k", KS)
def test_streaming_ragged_chunks_match_jax(k):
    """tests/test_streaming_count.py:12, reads of three lengths."""
    reads = [r.encode() for r in _reads(19, 600, 240, [45, 50, 60])]

    def chunks():
        for i in range(0, len(reads), 37):
            yield reads_to_matrix(reads[i:i + 37])

    want = jcount.count_kmers_streaming(chunks(), k=k, min_cov=2)
    got = tcount.count_kmers_streaming(chunks(), k=k, min_cov=2,
                                       device="cpu")
    _assert_table(got, want, k)
    assert len(want[1]) > 50


@pytest.mark.parametrize("k", KS)
def test_count_kmers_auto_streams_like_jax(monkeypatch, k):
    """tests/test_streaming_count.py:38: the window limit forced down so
    both packages stream in row chunks; and ``-partition`` alone."""
    rng = np.random.default_rng(3)
    R, L = 200, 80
    mat = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    lens = rng.integers(k + 3, L + 1, size=R).astype(np.int32)
    mat[np.arange(L)[None, :] >= lens[:, None]] = 0
    one_pass = tcount.count_kmers(mat, lens, k=k, min_cov=2, device="cpu")
    want = jdyn.count_kmers_auto(mat, lens, k=k, min_cov=2,
                                 max_cov=10_000_000, partitions=3)
    m = metrics.reset()
    got = tcount.count_kmers_auto(mat, lens, k=k, min_cov=2, partitions=3,
                                  device="cpu")
    assert m.counts["count.chunks"] == 3
    _assert_table(got, want, k)
    monkeypatch.setattr(jdyn, "STREAM_WINDOW_LIMIT", 3000)
    monkeypatch.setattr(tcount, "STREAM_WINDOW_LIMIT", 3000)
    want = jdyn.count_kmers_auto(mat, lens, k=k, min_cov=2,
                                 max_cov=10_000_000)
    m = metrics.reset()
    got = tcount.count_kmers_auto(mat, lens, k=k, min_cov=2, device="cpu")
    assert m.counts["count.chunks"] >= 4
    _assert_table(got, want, k)
    for a, b in zip(got, one_pass):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fmt,k", [("fastq", 21), ("fastq", 31),
                                   ("fastq", 33), ("fastq.gz", 31),
                                   ("fasta", 33)])
def test_count_from_files_matches_jax(tmp_path, fmt, k):
    """tests/test_streaming_count.py:81, in each input format: plain
    FASTQ in native byte ranges (1 MB at least), the others through the
    Python readers."""
    plain = fmt == "fastq"
    reads = _reads(7, 3000, 14000 if plain else 2000, [70], err=0.002)
    path = _write(tmp_path / f"reads.{fmt}", reads, fmt.split(".")[0])
    budget = 1 << 20 if plain else 32 << 10
    want = jcount.count_kmers_from_files(path, k=k, min_cov=2,
                                         budget_bytes=budget)
    m = metrics.reset()
    got = tcount.count_kmers_from_files(path, k=k, min_cov=2,
                                        budget_bytes=budget, device="cpu")
    assert m.counts["count.chunks"] > 1
    _assert_table(got, want, k)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    _assert_table(got, jcount.count_kmers(mat, lens, k=k, min_cov=2), k)
    assert len(want[1]) > 100


def test_spill_to_host_matches_jax(tmp_path, monkeypatch):
    """tests/test_streaming_count.py:110: a 1,500-row device table spills
    after every chunk of 32 kb of bases, in one k and in the one-pass
    ladder."""
    fq = _write(tmp_path / "reads.fq.gz", _reads(23, 3000, 3000, [70]))
    monkeypatch.setenv("REFLEXIV_DEVICE_TABLE_ROWS", "1500")
    m = metrics.reset()
    got = tcount.count_kmers_from_files(fq, k=31, min_cov=2,
                                        budget_bytes=32 << 10, device="cpu")
    assert m.counts["count.spills"] >= 3
    got_multi = tcount.count_kmers_from_files_multi(
        fq, KS, min_cov=2, budget_bytes=32 << 10, device="cpu")
    want = jcount.count_kmers_from_files(fq, k=31, min_cov=2,
                                         budget_bytes=32 << 10)
    want_multi = jcount.count_kmers_from_files_multi(
        fq, KS, min_cov=2, budget_bytes=32 << 10)
    _assert_table(got, want, 31)
    for k in KS:
        _assert_table(got_multi[k], want_multi[k], k)


def test_multi_k_matches_per_k_and_jax(tmp_path):
    """tests/test_streaming_count.py:149: the one-pass ladder equals each
    k counted alone (and the JAX ladder), W = 1 and 2 words together."""
    fq = _write(tmp_path / "r.fq", _reads(17, 2000, 2000, [70], err=0.002))
    klist = (21, 31, 33, 41)
    got = tcount.count_kmers_from_files_multi(
        fq, klist, min_cov=2, budget_bytes=32 << 10, device="cpu")
    want = jcount.count_kmers_from_files_multi(
        fq, klist, min_cov=2, budget_bytes=32 << 10)
    mat, lens = tio.load_reads(fq)
    for k in klist:
        _assert_table(got[k], want[k], k)
        one = tcount.count_kmers(mat, lens, k=k, min_cov=2, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(got[k], one)), k
        assert len(want[k][1]) > 50


def test_prefetch_parity_and_exception(tmp_path, monkeypatch):
    """tests/test_streaming_count.py:178: the prefetch thread changes no
    table, the three timers are written, and an exception in the producer
    reaches the consumer."""
    fq = _write(tmp_path / "r.fq", _reads(5, 1500, 1500, [70]))
    monkeypatch.setenv("REFLEXIV_PREFETCH", "0")
    serial = tcount.count_kmers_from_files(fq, k=31, min_cov=2,
                                           budget_bytes=16 << 10,
                                           device="cpu")
    monkeypatch.delenv("REFLEXIV_PREFETCH")
    m = metrics.reset()
    overlapped = tcount.count_kmers_from_files(fq, k=31, min_cov=2,
                                               budget_bytes=16 << 10,
                                               device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(serial, overlapped))
    assert m.timers["count.ingest_s"] > 0
    assert "count.input_stall_s" in m.timers
    assert "count.device_loop_s" in m.timers

    def boom():
        yield np.zeros((4, 40), np.uint8), np.full(4, 40, np.int32)
        raise RuntimeError("ingest exploded")

    with pytest.raises(RuntimeError, match="ingest exploded"):
        list(tcount._PrefetchedChunks(boom()))
    with pytest.raises(RuntimeError, match="ingest exploded"):
        tcount.count_kmers_streaming(tcount._maybe_prefetch(boom()), k=31,
                                     min_cov=1, device="cpu")


@pytest.mark.parametrize("minlen,limit", [(0, 0), (60, 0), (0, 9000),
                                          (60, 7000)])
def test_iter_read_chunks_reproduces_load_reads_filtered(tmp_path, minlen,
                                                         limit):
    """Chunks from disk hold the rows of the whole-matrix load, in order,
    under ``-minlength`` and ``-reads``: a plain FASTQ of several native
    byte ranges and a gzip one (the Python reader); then FASTA alone,
    against its reads (``load_reads`` parses one-line FASTA as FASTQ in
    both packages, ROADMAP Queue 3)."""
    reads = _reads(11, 5000, 12000, [40, 55, 70, 81])
    plain = _write(tmp_path / "a.fq", reads[:9000])
    _write(tmp_path / "b.fq.gz", reads[9000:])
    fasta = _write(tmp_path / "c.fa", reads[:3000], "fasta")
    params = Params(min_read_length=minlen, read_limit=limit)
    for pattern, budget, src in (
            (f"{plain},{tmp_path}/b.fq.gz", 1 << 20, reads),
            (fasta, 16 << 10, reads[:3000])):
        kept = [r for r in src if len(r) >= minlen][:limit or None]
        want = [bytes(encode_ascii(np.frombuffer(r.encode(), np.uint8)))
                for r in kept]
        if pattern != fasta:
            mat, lens = tio.load_reads_filtered(pattern, params)
            assert want == [bytes(mat[i, :n]) for i, n in enumerate(lens)]
        got, n_chunks = [], 0
        for cm, cl in tio.iter_read_chunks(pattern, params,
                                           budget_bytes=budget):
            n_chunks += 1
            assert cm.shape[1] == cl.max()
            got.extend(bytes(cm[i, :n]) for i, n in enumerate(cl))
        assert n_chunks > 1
        assert got == want
    assert tio.scan_max_read_length(f"{plain},{fasta}") == 81


def test_merges_saturate_and_match_jax(monkeypatch):
    """The device merge path and the fold of spilled segments: sums
    saturate at 2^31 - 1, and the fold of three segments equals the JAX
    package's host merge."""
    big = 2**31 - 10
    a = (torch.tensor([3, 5, 9, 12]), torch.tensor([1, big, 7, 2],
                                                   dtype=torch.int32))
    b = (torch.tensor([1, 5, 12, 20]), torch.tensor([4, 100, 3, 6],
                                                    dtype=torch.int32))
    c = (torch.tensor([5, 7]), torch.tensor([20, 1], dtype=torch.int32))
    keys, counts = tcount.merge_count_tables(*a, *b)
    assert keys.tolist() == [1, 3, 5, 9, 12, 20]
    assert counts.tolist() == [4, 1, 2**31 - 1, 7, 5, 6]
    monkeypatch.setenv("REFLEXIV_DEVICE_TABLE_ROWS", "1")
    table = tcount._RunningTable(21, torch.device("cpu"))
    for part in (a, b, c):
        table.add(*part)
    assert len(table.spilled) == 3
    hk, hc = table.finish(1, tcount.COUNT_MAX)
    assert hk.tolist() == [1, 3, 5, 7, 9, 12, 20]
    assert hc.tolist() == [4, 1, 2**31 - 1, 1, 7, 5, 6]
    jl, jc = jcount._host_merge_parts(
        [(limbs_from_keys(x[0], 21).numpy().astype(np.uint32), x[1].numpy())
         for x in (a, b, c)], 2)
    np.testing.assert_array_equal(limbs_from_keys(hk, 21).numpy(), jl)
    np.testing.assert_array_equal(hc.numpy(), jc)


@pytest.mark.parametrize("k", [31, 33])
def test_mercy_table_streams_like_jax(monkeypatch, k):
    """``mercy_kmer_table`` with both packages' count forced to stream."""
    reads = _reads(31, 800, 400, [60, 70], err=0.01)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    monkeypatch.setattr(jdyn, "STREAM_WINDOW_LIMIT", 2048)
    monkeypatch.setattr(tcount, "STREAM_WINDOW_LIMIT", 2048)
    want = jmercy.mercy_kmer_table(mat, lens, k=k, min_cov=3)
    m = metrics.reset()
    got = mercy.mercy_kmer_table(mat, lens, k=k, min_cov=3, device="cpu")
    assert m.counts["count.chunks"] > 5
    assert m.counts[f"mercy/rescued_k{k}"] > 0
    _assert_table(got, want, k)


def test_end_extend_window_index_in_chunks(monkeypatch):
    """End extension with the window index cut into many small chunks
    equals one chunk and the JAX package."""
    reads = _reads(41, 1200, 500, [100], err=0.005)
    rng = random.Random(2)
    g = "".join(rng.choice("ACGT") for _ in range(10))
    contigs = [r[10:70] for r in reads[:12]] + [g * 4]
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    args = (contigs, torch.from_numpy(mat), torch.from_numpy(lens))
    one = mapping.end_extend_arrays(*args)
    monkeypatch.setattr(mapping, "INDEX_WINDOWS", 500)
    index = mapping.WindowIndex(args[1], args[2], 31)
    assert len(index.chunks) == 72     # 7 reads of 70 windows each
    assert max(c[1] for c in index.chunks) == 9    # id bits per chunk
    got = mapping.end_extend_arrays(*args)
    assert got == one == jmapping.end_extend_arrays(contigs, mat, lens)
    assert sum(len(a) - len(b) for a, b in zip(got, contigs)) > 100


# ---------------------------------------------------------------------------
# the commands under REFLEXIV_INGEST_BUDGET_MB, through both CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def budget_inputs(tmp_path_factory):
    """A 1.2 kb genome's 100 bp reads at 28x in three FASTQ files: with a
    1 MB budget each file is a chunk of its own."""
    d = tmp_path_factory.mktemp("budget")
    reads = _reads(9, 1200, 340, [100], err=0.005)
    files = [_write(d / f"r{i}.fq", reads[i::3]) for i in range(3)]
    return d, ",".join(files)


def _budget_run(argv, root, monkeypatch):
    """Both CLIs under a 1 MB budget (both packages in the indexed loop);
    returns the port's metrics."""
    monkeypatch.setenv("REFLEXIV_INGEST_BUDGET_MB", "1")
    monkeypatch.setenv("REFLEXIV_INDEXED_ALWAYS", "1")
    run_both(argv, root, monkeypatch)     # undoes the patches
    with open(root / "port" / "metrics.json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("cmd", ["counter", "run"])
def test_cli_counter_and_run_under_budget_match_jax(budget_inputs, tmp_path,
                                                    monkeypatch, cmd):
    _d, fq = budget_inputs
    met = _budget_run([cmd, "-fastq", fq, "-kmer", "31", "-cover", "2"],
                      tmp_path, monkeypatch)
    assert met["counters"]["count.chunks"] == 3
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    name = "Count_31/part-00000.csv.gz" if cmd == "counter" else "part-00000"
    assert set(got) == set(want) and name in got
    if cmd == "counter":   # gzip stamps a time: compare what it holds
        got[name], want[name] = (gzip.decompress(t[name])
                                 for t in (got, want))
    assert got == want
    assert len(got[name]) > 1000


def test_cli_reduce_under_budget_matches_jax(budget_inputs, tmp_path,
                                             monkeypatch):
    _d, fq = budget_inputs
    met = _budget_run(["reduce", "-fastq", fq, "-cover", "2", "-klist",
                       "23,41"], tmp_path, monkeypatch)
    # one count per k and the stitch table, three chunks each
    assert met["counters"]["count.chunks"] == 9
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got == want
    assert "Count_41_reduced/part-00000.csv" in got


def test_cli_meta_under_budget_matches_jax(budget_inputs, tmp_path,
                                           monkeypatch):
    _d, fq = budget_inputs
    met = _budget_run(["meta", "-fastq", fq, "-cover", "2", "-klist",
                       "23,41", "-mincontig", "500"], tmp_path,
                      monkeypatch)
    assert met["counters"]["count.chunks"] == 3     # one pass, every k
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    sorted00 = [r for r in want if r.startswith("steps/00sorted")]
    assert len(sorted00) >= 3
    for rel in sorted00 + ["Assembly/part-00000"]:
        assert got[rel] == want[rel], rel
    assert len(got["Assembly/part-00000"]) > 1000
