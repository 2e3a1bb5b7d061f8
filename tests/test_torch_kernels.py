"""The port's two CUDA kernels against their plain torch versions.

This file imports no jax, so the ``cuda``-marked tests run on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card those tests skip; the rest check the wrappers' CPU route and
argument checks. Every comparison is exact (integer keys)."""
import numpy as np
import pytest
import torch

from reflexiv_tpu_torch.kernels import extract as ext
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


@pytest.mark.cuda
def test_sort_kernel_full_62_bit_keys():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randint(0, 1 << 62, (3_000_001,), generator=g, device=dev)
    got = radix_sort.sort_keys(keys, bits=62)
    assert torch.equal(got, torch.sort(keys).values)
