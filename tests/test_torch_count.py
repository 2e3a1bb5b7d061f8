"""Parity: the port's count table against ``reflexiv_tpu.count.count_kmers``,
array for array once exported with ``limbs_from_keys`` (exact: integers)."""
import os
import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import oracle
from reflexiv_tpu import count as jcount
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu_torch import count as tcount
from reflexiv_tpu_torch import kmer_io
from reflexiv_tpu_torch.bitpack import limbs_from_keys


def _reads(seed, n_reads=150):
    """Reads from a small genome at depth, both strands, some errors and a
    spread of lengths (including ones too short to yield a k-mer)."""
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(400))
    reads = []
    for _ in range(n_reads):
        n = rng.choice([18, 30, 33, 60, 80])
        s = rng.randrange(len(genome) - n)
        r = [c if rng.random() > 0.01 else rng.choice("ACGT")
             for c in genome[s:s + n]]
        r = "".join(r)
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return reads


@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("clips", [(0, 0), (2, 3)])
@pytest.mark.parametrize("band", [(1, 2_000_000_000), (2, 6)])
def test_count_table_matches_jax(k, clips, band):
    mat, lens = reads_to_matrix([r.encode() for r in _reads(k)])
    fc, ec = clips
    want_l, want_c = jcount.count_kmers(
        mat, lens, k=k, min_cov=band[0], max_cov=band[1],
        front_clip=fc, end_clip=ec)
    keys, counts = tcount.count_kmers(
        mat, lens, k=k, min_cov=band[0], max_cov=band[1],
        front_clip=fc, end_clip=ec, device="cpu")
    assert keys.dtype == torch.int64 and counts.dtype == torch.int32
    assert len(want_c) > 0
    np.testing.assert_array_equal(
        limbs_from_keys(keys, k).numpy().astype(np.uint32), want_l)
    np.testing.assert_array_equal(counts.numpy(), want_c)


def test_merge_count_tables_matches_jax():
    k = 21
    mat, lens = reads_to_matrix([r.encode() for r in _reads(3)])
    mat2, lens2 = reads_to_matrix([r.encode() for r in _reads(4)])
    tables = [tcount.count_kmers(m, l, k=k, min_cov=1, device="cpu")
              for m, l in ((mat, lens), (mat2, lens2))]
    keys, counts = tcount.merge_count_tables(*tables[0], *tables[1])
    jl, jc, jk = jcount.merge_count_tables(
        *(jnp.asarray(x) for x in (
            limbs_from_keys(tables[0][0], k).numpy().astype(np.uint32),
            tables[0][1].numpy(),
            limbs_from_keys(tables[1][0], k).numpy().astype(np.uint32),
            tables[1][1].numpy())))
    jk = np.asarray(jk)
    np.testing.assert_array_equal(
        limbs_from_keys(keys, k).numpy().astype(np.uint32), np.asarray(jl)[jk])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc)[jk])


def test_count_table_csv_round_trip(tmp_path):
    k = 31
    mat, lens = reads_to_matrix([r.encode() for r in _reads(5)])
    keys, counts = tcount.count_kmers(mat, lens, k=k, min_cov=1, device="cpu")
    path = kmer_io.write_count_table(str(tmp_path / "Count_31"), keys,
                                     counts, k)
    assert os.path.exists(tmp_path / "Count_31" / "_SUCCESS")
    rkeys, rcounts = kmer_io.read_count_table(path, k)
    assert torch.equal(rkeys, keys) and torch.equal(rcounts, counts)


@pytest.mark.parametrize("with_frag", [False, True])
def test_cli_counter_writes_the_jax_table(tmp_path, with_frag):
    """``counter`` (with ``-frag`` fragments merged in, or not) writes the
    same ``Count_<k>`` CSV as the JAX package's ``counter``."""
    import gzip

    from reflexiv_tpu.cli import main as jax_main
    from reflexiv_tpu_torch.cli import main as torch_main

    reads = _reads(6)
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    args = ["counter", "-fastq", str(fq), "-kmer", "21", "-cover", "2"]
    if with_frag:
        frag = tmp_path / "frag.fa"
        frag.write_text(">f0\n" + reads[0] + reads[1] + "\n>f1\n"
                        + reads[2] * 3 + "\n")
        args += ["-frag", str(frag)]
    jax_main(args + ["-outfile", str(tmp_path / "jax")])
    torch_main(args + ["-outfile", str(tmp_path / "port"), "-device", "cpu"])
    tables = [gzip.open(tmp_path / d / "Count_21" / "part-00000.csv.gz",
                        "rt").read() for d in ("jax", "port")]
    assert tables[0] and tables[0] == tables[1]
