"""Parity for k >= 32: the port's W-word keys against the JAX package's
``ceil(k/16)`` uint32 limbs, for packing, count tables, fork-filtered
records and the ``counter`` CLI. Exact: everything is integer."""
import torch_threads  # noqa: F401
import gzip
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from reflexiv_tpu import bitpack as jbp
from reflexiv_tpu import count as jcount
from reflexiv_tpu.graph import build_initial_records as jax_build
from reflexiv_tpu.io import reads_to_matrix
from reflexiv_tpu_torch import bitpack as tbp
from reflexiv_tpu_torch import count as tcount
from reflexiv_tpu_torch.graph import build_initial_records
from reflexiv_tpu_torch.kernels import radix_sort


def _reads(seed, n_reads=120):
    """Both-strand reads with 1% substitutions from a 700 bp genome that
    holds a 100 bp poly-T run, in lengths that give k = 95 some windows."""
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(600))
    genome = genome[:300] + "T" * 100 + genome[300:]
    reads = []
    for _ in range(n_reads):
        n = rng.choice([30, 64, 100, 130])
        s = rng.randrange(len(genome) - n)
        r = "".join(c if rng.random() > 0.01 else rng.choice("ACGT")
                    for c in genome[s:s + n])
        reads.append(oracle.revcomp(r) if rng.random() < 0.5 else r)
    return reads


def _limbs(keys, k):
    return tbp.limbs_from_keys(keys, k).numpy().astype(np.uint32)


@pytest.mark.parametrize("k", [32, 33, 61, 62, 81, 95, 99])
def test_pack_unpack_and_converters_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (200, k), dtype=np.uint8)
    codes[0], codes[1] = 0, 3                # poly-A, poly-T
    limbs = np.asarray(jbp.pack_bases(jnp.asarray(codes), k))
    keys = tbp.pack_bases(torch.from_numpy(codes), k)
    assert keys.shape == (200, tbp.num_words(k))
    assert int(keys.min()) >= 0 and int(keys.max()) < 1 << 62
    np.testing.assert_array_equal(_limbs(keys, k), limbs)
    assert torch.equal(tbp.keys_from_limbs(limbs, k), keys)
    np.testing.assert_array_equal(tbp.unpack_bases(keys, k).numpy(), codes)
    assert keys[1].tolist() == tbp.poly_t(k)
    rc = tbp.revcomp_keys(keys, k)
    jrc = jbp.revcomp_packed(jnp.asarray(limbs), k)
    np.testing.assert_array_equal(_limbs(rc, k), np.asarray(jrc))
    np.testing.assert_array_equal(
        _limbs(tbp.canonical_rows(keys, rc), k),
        np.asarray(jbp.canonical_packed(jnp.asarray(limbs), jrc)))


@pytest.mark.parametrize("width", [31, 32, 33, 47, 48, 64, 80, 94, 96])
def test_group_sentinel_orders_as_all_ones_limbs(width):
    """All-ones limbs sit above every key, and equal poly-T exactly where
    the key fills its limbs (width a multiple of 16)."""
    sent = torch.as_tensor(tbp.group_sentinel(width))
    poly_t = torch.as_tensor(tbp.poly_t(width))
    if width % 16 == 0:
        assert torch.equal(sent, poly_t)
    elif sent.dim() == 0:
        assert int(sent) > int(poly_t)
    else:
        assert bool(tbp.rows_less_equal(poly_t, sent)) and \
            not torch.equal(sent, poly_t)


@pytest.mark.parametrize("k", [32, 33, 41, 61, 81, 95])
@pytest.mark.parametrize("clips", [(0, 0), (2, 3)])
def test_count_table_matches_jax(k, clips):
    mat, lens = reads_to_matrix([r.encode() for r in _reads(k)])
    fc, ec = clips
    want_l, want_c = jcount.count_kmers(mat, lens, k=k, min_cov=1,
                                        front_clip=fc, end_clip=ec)
    keys, counts = tcount.count_kmers(mat, lens, k=k, min_cov=1,
                                      front_clip=fc, end_clip=ec,
                                      device="cpu")
    assert len(want_c) > 0 and keys.shape == (len(want_c), tbp.num_words(k))
    np.testing.assert_array_equal(_limbs(keys, k), want_l)
    np.testing.assert_array_equal(counts.numpy(), want_c)


def test_count_band_and_merge_match_jax():
    k = 61
    mat, lens = reads_to_matrix([r.encode() for r in _reads(3)])
    mat2, lens2 = reads_to_matrix([r.encode() for r in _reads(4)])
    want_l, want_c = jcount.count_kmers(mat, lens, k=k, min_cov=2, max_cov=5)
    keys, counts = tcount.count_kmers(mat, lens, k=k, min_cov=2, max_cov=5,
                                      device="cpu")
    np.testing.assert_array_equal(_limbs(keys, k), want_l)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    tables = [tcount.count_kmers(m, l, k=k, min_cov=1, device="cpu")
              for m, l in ((mat, lens), (mat2, lens2))]
    keys, counts = tcount.merge_count_tables(*tables[0], *tables[1])
    jl, jc, jk = jcount.merge_count_tables(*(jnp.asarray(x) for x in (
        _limbs(tables[0][0], k), tables[0][1].numpy(),
        _limbs(tables[1][0], k), tables[1][1].numpy())))
    jk = np.asarray(jk)
    np.testing.assert_array_equal(_limbs(keys, k), np.asarray(jl)[jk])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc)[jk])


def test_plain_row_sort_is_lexicographic():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 5, (5000, 3)).astype(np.int64)
    got = radix_sort.sort_rows_torch(torch.from_numpy(rows)).numpy()
    want = rows[np.lexsort(rows.T[::-1])]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [33, 41, 65, 81])
def test_records_match_jax_row_for_row(k):
    """Every k here reads the 100 bp poly-T run; at 33, 65 and 81 a group
    width (k - 1) is a multiple of 16, where a live poly-T group key ties
    with the dead rows' all-ones limbs."""
    reads = _reads(10 + k)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    keys, counts = tcount.count_kmers(mat, lens, k=k, min_cov=1,
                                      device="cpu")
    assert bool((keys == 0).all(1).any()), "poly-A (poly-T's canonical "\
        "form) must be counted"
    recs = build_initial_records(keys, counts, k=k, min_error=8)
    jrecs, _marker = jax_build(jnp.asarray(_limbs(keys, k)),
                               jnp.asarray(counts.numpy()), k=k, min_error=8)
    for got, want in zip(recs, jrecs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(recs.live.sum()) > 0


def test_cli_counter_k41_writes_the_jax_table(tmp_path):
    from reflexiv_tpu.cli import main as jax_main
    from reflexiv_tpu_torch.cli import main as torch_main

    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(_reads(6))))
    args = ["counter", "-fastq", str(fq), "-kmer", "41", "-cover", "2"]
    jax_main(args + ["-outfile", str(tmp_path / "jax")])
    assert torch_main(args + ["-outfile", str(tmp_path / "port"),
                              "-device", "cpu"]) == 0
    tables = [gzip.open(tmp_path / d / "Count_41" / "part-00000.csv.gz",
                        "rb").read() for d in ("jax", "port")]
    assert tables[0] and tables[0] == tables[1]


def test_count_table_gzip_blocks_read_back_in_both_packages(tmp_path,
                                                            monkeypatch):
    """A table written as several gzip members (one per block of rows)
    reads back, through both packages' readers, as the table written."""
    from reflexiv_tpu import kmer_io as jkio
    from reflexiv_tpu_torch import kmer_io as tkio

    monkeypatch.setattr(tkio, "ROWS_PER_BLOCK", 7)
    k = 41
    mat, lens = reads_to_matrix([r.encode() for r in _reads(8)])
    keys, counts = tcount.count_kmers(mat, lens, k=k, min_cov=1,
                                      device="cpu")
    path = tkio.write_count_table(str(tmp_path / "Count_41"), keys, counts, k)
    rkeys, rcounts = tkio.read_count_table(path, k)
    assert torch.equal(rkeys, keys) and torch.equal(rcounts, counts)
    jl, jc = jkio.read_count_table(path, k)
    np.testing.assert_array_equal(jl, _limbs(keys, k))
    np.testing.assert_array_equal(jc, counts.numpy())
