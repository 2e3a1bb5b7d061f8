"""The port's CUDA kernels against their plain torch versions.

This file imports no jax, so the ``cuda``-marked tests run on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card those tests skip; the rest check the wrappers' CPU route and
argument checks. Every comparison is exact (integer keys)."""
import numpy as np
import pytest
import torch

from reflexiv_tpu_torch.bitpack import word_bases
from reflexiv_tpu_torch.kernels import extract as ext
from reflexiv_tpu_torch.kernels import partition
from reflexiv_tpu_torch.kernels import radix_sort


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _reads(n, L, seed):
    rng = np.random.default_rng(seed)
    mat = torch.from_numpy(rng.integers(0, 4, (n, L), dtype=np.uint8))
    lens = torch.from_numpy(rng.integers(0, L + 1, n).astype(np.int32))
    return mat, lens


def _counting_keys(k, n, seed):
    """Few distinct keys (heavy duplicates) and the sentinel at random
    places, as the counting pass makes them."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << (2 * k), 97, dtype=np.int64)
    keys = pool[rng.integers(0, len(pool), n)]
    keys[rng.random(n) < 0.3] = ext.sentinel(k)
    return torch.from_numpy(keys)


def test_extract_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    mat, lens = _reads(50, 60, 1)
    before = ext.LAUNCHES
    assert torch.equal(ext.extract_canonical_keys(mat, lens, k=31),
                       ext.extract_canonical_keys_torch(mat, lens, k=31))
    assert ext.LAUNCHES == before


def test_extract_wrapper_rejects_bad_arguments():
    with pytest.raises(ValueError):      # neither CPU nor CUDA
        ext.extract_canonical_keys(
            torch.zeros((4, 40), dtype=torch.uint8, device="meta"),
            torch.zeros(4, dtype=torch.int32, device="meta"), k=21)
    with pytest.raises(ValueError):      # matrix narrower than k
        ext.extract_canonical_keys(torch.zeros((4, 20), dtype=torch.uint8),
                                   torch.zeros(4, dtype=torch.int32), k=21)
    with pytest.raises(ValueError):      # k beyond one int64 key
        ext.extract_canonical_keys(torch.zeros((4, 40), dtype=torch.uint8),
                                   torch.zeros(4, dtype=torch.int32), k=32)


def test_sort_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    keys = _counting_keys(31, 5000, seed=3)
    before = radix_sort.LAUNCHES
    assert torch.equal(radix_sort.sort_keys(keys, bits=62),
                       radix_sort.sort_keys_torch(keys))
    assert radix_sort.LAUNCHES == before


def test_sort_wrapper_rejects_bad_arguments():
    with pytest.raises(ValueError):
        radix_sort.sort_keys(torch.zeros(8, dtype=torch.int64), bits=0)
    with pytest.raises(TypeError):
        radix_sort.sort_keys(torch.zeros(8, dtype=torch.int32), bits=8)
    with pytest.raises(ValueError):
        radix_sort.sort_keys(
            torch.zeros(8, dtype=torch.int64, device="meta"), bits=8)


def test_sort_wrappers_refuse_more_keys_than_the_offsets_hold():
    n = radix_sort.MAX_N + 1
    with pytest.raises(ValueError, match="bound"):
        radix_sort.sort_keys(torch.empty(n, dtype=torch.int64, device="meta"),
                             bits=62)
    with pytest.raises(ValueError, match="bound"):
        radix_sort.sort_rows(
            torch.empty((n, 2), dtype=torch.int64, device="meta"),
            last_bits=62)


def _play_plan(rows, plan):
    """Run a pass plan with numpy stable sorts and two buffers each of keys
    and indices, as the kernel does; a pass may read only what the pass
    before it wrote."""
    n, W = rows.shape
    keys, idx, out = [None, None], [None, None], None
    wrote = {}
    for p, (word, shift, key_src, idx_src, dst, flags) in enumerate(plan):
        if idx_src < 0:
            ids = np.arange(n)
        else:
            assert wrote.get(("idx", idx_src)) == p - 1
            ids = idx[idx_src]
        if key_src < 0:
            key = rows[ids, word]
        else:
            assert wrote.get(("key", key_src)) == p - 1
            key = keys[key_src]
        order = np.argsort((key >> shift) & 255, kind="stable")
        if flags & radix_sort.WRITE_ROWS:
            assert p == len(plan) - 1
            out = rows[ids[order]]
            continue
        if flags & radix_sort.WRITE_KEYS:
            keys[dst], wrote[("key", dst)] = key[order], p
        if W > 1:
            idx[dst], wrote[("idx", dst)] = ids[order], p
    if W == 1:
        assert wrote[("key", 0)] == len(plan) - 1   # the result buffer
        return keys[0][:, None]
    return out


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_pass_plan_sorts_for_every_bit_width(W):
    """Every bits in 1-63 (keys) and every last_bits in 1-62 (W words):
    the plan has ceil(bits / 8) passes per word, its last pass writes the
    result (buffer 0, or the rows), and played pass by pass it sorts."""
    rng = np.random.default_rng(W)
    for last in range(1, 64 if W == 1 else 63):
        plan = radix_sort.pass_plan(W, last)
        assert len(plan) == 8 * (W - 1) + -(-last // 8)
        assert plan.dtype == np.int32 and plan.shape[1] == 6
        assert plan[-1, 4] == 0
        rows = rng.integers(0, 1 << 62, (300, W), dtype=np.int64)
        rows[:, -1] &= (1 << last) - 1
        rows[::3, :-1] = rows[0, :-1]          # ties on the leading words
        want = rows[np.lexsort(rows.T[::-1])]
        np.testing.assert_array_equal(_play_plan(rows, plan), want)


def test_pass_plan_rejects_what_the_kernel_cannot_take():
    for W, last in ((0, 8), (5, 8), (1, 0), (1, 64), (2, 63), (4, 0)):
        with pytest.raises(ValueError):
            radix_sort.pass_plan(W, last)


@pytest.mark.cuda
@pytest.mark.parametrize("k,front_clip,end_clip",
                         [(31, 0, 0), (21, 3, 2), (17, 0, 5), (1, 0, 0)])
def test_extract_kernel_matches_plain(k, front_clip, end_clip):
    dev = _card()
    mat, lens = _reads(5000, 100, k)
    want = ext.extract_canonical_keys_torch(
        mat, lens, k=k, front_clip=front_clip, end_clip=end_clip)
    before = ext.LAUNCHES
    got = ext.extract_canonical_keys(
        mat.to(dev), lens.to(dev), k=k, front_clip=front_clip,
        end_clip=end_clip)
    torch.cuda.synchronize()
    assert ext.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(31, 1_000_003), (31, 4096), (21, 4097),
                                 (9, 77), (4, 1)])
def test_sort_kernel_matches_plain(k, n):
    dev = _card()
    keys = _counting_keys(k, n, seed=n)
    before = radix_sort.LAUNCHES
    got = radix_sort.sort_keys(keys.to(dev), bits=2 * k)
    torch.cuda.synchronize()
    assert radix_sort.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), radix_sort.sort_keys_torch(keys))


def _sort_tile(pairs):
    from reflexiv_tpu_torch.kernels import build

    return build.lib().rfx_radix_sort_tile(pairs)


def _few_digit_values(n, seed):
    """Keys whose every byte takes one of three values: each pass moves
    long runs of equal digits, so an unstable pass scrambles the order the
    earlier passes made."""
    rng = np.random.default_rng(seed)
    vals = np.array([0x00, 0x01, 0x3F], np.int64)
    keys = np.zeros(n, np.int64)
    for b in range(8):
        keys |= vals[rng.integers(0, 3, n)] << (8 * b)
    return torch.from_numpy(keys)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["few_digit_values", "all_equal"])
@pytest.mark.parametrize("at", ["1", "tile-1", "tile", "tile+1",
                                "5tiles+1"])
def test_sort_kernel_tile_edges(case, at):
    dev = _card()
    tile = _sort_tile(0)
    n = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "5tiles+1": 5 * tile + 1}[at]
    if case == "all_equal":
        keys = torch.full((n,), (1 << 61) + 12345, dtype=torch.int64)
    else:
        keys = _few_digit_values(n, seed=n)
    got = radix_sort.sort_keys(keys.to(dev), bits=62)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), radix_sort.sort_keys_torch(keys))


@pytest.mark.cuda
def test_sort_kernel_full_62_bit_keys():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randint(0, 1 << 62, (3_000_001,), generator=g, device=dev)
    got = radix_sort.sort_keys(keys, bits=62)
    assert torch.equal(got, torch.sort(keys).values)


def _counting_rows(k, n, seed):
    """Word rows as the counting pass makes them: few distinct keys, rows
    sharing their leading words, and poly-T sentinel rows."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 1 << (2 * b), 41, dtype=np.int64)
             for b in word_bases(k)]
    pool = np.stack(words, axis=1)
    pool[::3, 0] = pool[0, 0]              # ties on the first word
    rows = pool[rng.integers(0, len(pool), n)]
    rows[rng.random(n) < 0.3] = ext.sentinel(k)
    return torch.from_numpy(rows)


def _exchange_inputs(block, nb, maxrun, seed):
    rng = np.random.default_rng(seed)
    n = block * nb
    hi = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint32)
                          .view(np.int32))
    lo = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint32)
                          .view(np.int32))
    from reflexiv_tpu_torch.partition_kernels import group_blocks

    hi_g, lo_g, starts = group_blocks(hi, lo, block=block, shift=24)
    pad = torch.zeros(maxrun, dtype=torch.int32)
    return torch.cat([hi_g, pad]), torch.cat([lo_g, pad]), starts


def test_row_wrappers_on_cpu_run_plain_and_count_no_launch():
    mat, lens = _reads(40, 120, 2)
    before = (dict(ext.ROW_LAUNCHES), dict(radix_sort.ROW_LAUNCHES))
    rows = ext.extract_canonical_rows(mat, lens, k=61)
    assert torch.equal(rows, ext.extract_canonical_rows_torch(mat, lens, k=61))
    assert torch.equal(radix_sort.sort_rows(rows, last_bits=60),
                       radix_sort.sort_rows_torch(rows))
    assert (ext.ROW_LAUNCHES, radix_sort.ROW_LAUNCHES) == before


def test_partition_wrappers_on_cpu_run_plain_and_count_no_launch():
    hi, lo, starts = _exchange_inputs(1024, 2, 64, seed=4)
    before = (partition.EXCHANGE_LAUNCHES, partition.GATHER_LAUNCHES)
    got = partition.padded_exchange(hi, lo, starts, block=1024, maxrun=64)
    want = partition.padded_exchange_torch(hi, lo, starts, block=1024,
                                           maxrun=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tiles = torch.arange(1024, dtype=torch.int32) % 2 * 1024
    assert torch.equal(partition.tile_gather(hi, tiles),
                       partition.tile_gather_torch(hi, tiles))
    assert (partition.EXCHANGE_LAUNCHES, partition.GATHER_LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("k,front_clip,end_clip",
                         [(32, 0, 0), (61, 3, 2), (62, 0, 0), (81, 0, 4),
                          (95, 0, 0), (99, 1, 1)])
def test_extract_rows_kernel_matches_plain(k, front_clip, end_clip):
    dev = _card()
    mat, lens = _reads(3000, 120, k)
    want = ext.extract_canonical_rows_torch(
        mat, lens, k=k, front_clip=front_clip, end_clip=end_clip)
    W = len(word_bases(k))
    before = ext.ROW_LAUNCHES.get(W, 0)
    got = ext.extract_canonical_rows(
        mat.to(dev), lens.to(dev), k=k, front_clip=front_clip,
        end_clip=end_clip)
    torch.cuda.synchronize()
    assert ext.ROW_LAUNCHES[W] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(32, 1_000_003), (61, 4097), (81, 77_777),
                                 (95, 300_001), (99, 1)])
def test_sort_rows_kernel_matches_plain(k, n):
    dev = _card()
    rows = _counting_rows(k, n, seed=k)
    W = rows.shape[1]
    before = radix_sort.ROW_LAUNCHES.get(W, 0)
    got = radix_sort.sort_rows(rows.to(dev),
                               last_bits=2 * word_bases(k)[-1])
    torch.cuda.synchronize()
    assert radix_sort.ROW_LAUNCHES[W] == before + 1
    assert torch.equal(got.cpu(), radix_sort.sort_rows_torch(rows))


def _tied_rows(W, n, seed):
    """Rows equal on every word but the last in long runs, rows that differ
    only in the first word, and poly-T sentinel rows."""
    rng = np.random.default_rng(seed)
    k = 31 * (W - 1) + 20
    rows = np.repeat(rng.integers(0, 1 << 62, (7, W), dtype=np.int64),
                     -(-n // 7), axis=0)[:n]
    rows[:, -1] = rng.integers(0, 3, n) << 37          # the last word
    rows[1::5, 0] = rng.integers(0, 2, rows[1::5].shape[0])
    rows[rng.random(n) < 0.2] = ext.sentinel(k)
    return torch.from_numpy(rows[rng.permutation(n)]), 40


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 3, 4])
@pytest.mark.parametrize("at", ["1", "tile-1", "tile+1", "5tiles+1"])
def test_sort_rows_kernel_ties_and_sentinels(W, at):
    dev = _card()
    tile = _sort_tile(1)
    n = {"1": 1, "tile-1": tile - 1, "tile+1": tile + 1,
         "5tiles+1": 5 * tile + 1}[at]
    rows, last_bits = _tied_rows(W, n, seed=W * n)
    got = radix_sort.sort_rows(rows.to(dev), last_bits=last_bits)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), radix_sort.sort_rows_torch(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("block,nb,maxrun", [(1 << 16, 16, 1024),
                                             (4096, 8, 1001),
                                             (1024, 3, 4096)])
def test_padded_exchange_kernel_matches_plain(block, nb, maxrun):
    dev = _card()
    hi, lo, starts = _exchange_inputs(block, nb, maxrun, seed=block + nb)
    want = partition.padded_exchange_torch(hi, lo, starts, block=block,
                                           maxrun=maxrun)
    before = partition.EXCHANGE_LAUNCHES
    got = partition.padded_exchange(hi.to(dev), lo.to(dev), starts.to(dev),
                                    block=block, maxrun=maxrun)
    torch.cuda.synchronize()
    assert partition.EXCHANGE_LAUNCHES == before + 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles,repeated", [(4096, False), (65_536, False),
                                            (65_536, True), (1024, True)])
def test_tile_gather_kernel_matches_plain(tiles, repeated):
    dev = _card()
    rng = np.random.default_rng(tiles + repeated)
    src = torch.from_numpy(rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint32)
                           .view(np.int32))
    pick = rng.integers(0, 1023, 8 if repeated else tiles)
    starts = torch.from_numpy(
        (pick[rng.integers(0, len(pick), tiles)] if repeated else pick)
        .astype(np.int32) * 1024)
    before = partition.GATHER_LAUNCHES
    got = partition.tile_gather(src.to(dev), starts.to(dev))
    torch.cuda.synchronize()
    assert partition.GATHER_LAUNCHES == before + 1
    assert torch.equal(got.cpu(), partition.tile_gather_torch(src, starts))

