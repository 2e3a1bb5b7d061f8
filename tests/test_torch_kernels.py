"""The port's CUDA kernels against their plain torch versions.

This file imports no jax, so the ``cuda``-marked tests run on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card those tests skip; the rest check the wrappers' CPU route and
argument checks. Every comparison is exact (integer keys)."""
import torch_threads  # noqa: F401
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


@pytest.mark.parametrize("k", [1, 31, 32, 62, 63, 94, 99])
@pytest.mark.parametrize("L", [None, 101, 4096, 16_384, 16_385, 1 << 20])
def test_launch_geometry_fits_two_ctas_per_sm(k, L):
    """At least one read per CTA, whole reads unless a row is longer than
    the stage, and shared memory for two CTAs on one SM (each CTA also
    takes 1 KB of the SM's 228 KB)."""
    L = L or k
    g = ext.launch_geometry(L, k)
    wn = L - k + 1
    assert g.reads >= 1 and g.windows >= 1
    assert g.ctas_per_read == -(-wn // g.windows)
    if L <= ext.STAGE_BASES:
        assert g.ctas_per_read == 1 and g.windows == wn
        assert g.reads * L <= ext.STAGE_BASES
        assert g.reads == ext.MAX_READS or (g.reads + 1) * L > ext.STAGE_BASES
    else:
        assert g.reads == 1 and g.windows + k - 1 == ext.STAGE_BASES
    assert 2 * (g.smem_bytes + 1024) <= 228 * 1024   # an H100 SM's
    assert g.smem_bytes % 8 == 0


def _pack16(chunks):
    """(n, 16) codes -> n uint32, first base high, through the kernel's
    ``pack4``: mask, byte reversal, two shift-ors."""
    v = (chunks.astype(np.uint64) & 3)
    out = np.zeros(len(chunks), np.uint64)
    for q in range(4):
        b = v[:, 4 * q: 4 * q + 4]
        s = b[:, 3] | (b[:, 2] << 8) | (b[:, 1] << 16) | (b[:, 0] << 24)
        s |= s >> 6
        s |= s >> 12
        out |= (s & 0xFF) << (8 * (3 - q))
    return out


_BREV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint64)


def _revcomp16(f):
    """The kernel's ``revcomp16``: bit reversal, pair swap, complement."""
    r = np.zeros_like(f)
    for q in range(4):
        r |= _BREV8[(f >> (8 * q)) & 0xFF] << (8 * (3 - q))
    r = ((r >> 1) & 0x55555555) | ((r & 0x55555555) << 1)
    return ~r & 0xFFFFFFFF


def _cut(stream, pos, n):
    c, sh = pos >> 4, (2 * (pos & 15)).astype(np.uint64)
    a, b, d = stream[c], stream[c + 1], stream[c + 2]
    hi = ((a << sh) | (b >> (np.uint64(32) - sh))) & 0xFFFFFFFF
    lo = ((b << sh) | (d >> (np.uint64(32) - sh))) & 0xFFFFFFFF
    return ((hi << np.uint64(32)) | lo) >> np.uint64(64 - 2 * n)


def _kernel_model(mat, lens, k, front_clip, end_clip, addr):
    """``csrc/extract_kmers.cu`` step by step in numpy, for a matrix whose
    first byte sits at ``addr`` mod 16: each CTA's span from the 16-byte
    chunk holding its first byte, the packed and mirrored rc streams, the
    window bounds, the threads' (read, window) steps from the 32-window
    boundary of the output before the CTA's first window, and the
    funnel-shift cuts. Returns the ``(R * wn, W)`` keys and checks every CTA's shared
    memory against the geometry."""
    R, L = mat.shape
    W, wn, T = len(word_bases(k)), L - k + 1, ext.THREADS
    geo = ext.launch_geometry(L, k)
    flat = mat.reshape(-1)
    out = np.full((R * wn, W), -1, np.int64)
    sent = np.array(ext.sentinel(k), np.int64).reshape(-1)
    n_of = word_bases(k)
    ctas = (-(-R // geo.reads) if geo.ctas_per_read == 1
            else R * geo.ctas_per_read)
    for blk in range(ctas):
        if geo.ctas_per_read == 1:
            r0, w0, nw = blk * geo.reads, 0, wn
            nr = min(geo.reads, R - r0)
        else:
            r0, nr = blk // geo.ctas_per_read, 1
            w0 = blk % geo.ctas_per_read * geo.windows
            nw = min(geo.windows, wn - w0)
        start, span = r0 * L + w0, (nr - 1) * L + nw + k - 1
        off = (addr + start) % 16
        nch = (off + span + 15) // 16
        stage = 8 * T * W if W > 1 else 0
        assert stage + 8 * nr + 8 * (nch + 2) <= geo.smem_bytes
        buf = np.zeros(16 * nch, np.uint8)
        buf[off: off + span] = flat[start: start + span]
        fwd = _pack16(buf.reshape(nch, 16))
        pad = np.zeros(2, np.uint64)
        rc = np.concatenate([_revcomp16(fwd)[::-1], pad])
        fwd = np.concatenate([fwd, pad])
        ln = lens[r0: r0 + nr].astype(np.int64)
        ok = (ln - k - end_clip > 1) & (front_clip <= ln)
        lo = np.where(ok, front_clip, 1)
        hi = np.where(ok, np.minimum(ln - end_clip - k, wn - 1), 0)
        total, row = nr * nw, L if nr > 1 else 0
        lead = (r0 * wn + w0) % 32
        t = np.arange(T)
        sit_out = t < lead
        g0 = t - lead + np.where(sit_out, T, 0)
        rl, wl = g0 // nw, g0 % nw
        p = off + rl * row + wl
        for base in range(-lead, total, T):
            g = base + t
            live = ~sit_out & (g < total)
            assert np.all(g[live] >= 0)
            gl, rr, ww, pp = g[live], rl[live], wl[live] + w0, p[live]
            valid = (ww >= lo[rr]) & (ww <= hi[rr])
            f = np.stack([_cut(fwd, pp + 31 * i, n)
                          for i, n in enumerate(n_of)], 1).astype(np.int64)
            c = np.stack([_cut(rc, 16 * nch - k - pp + 31 * i, n)
                          for i, n in enumerate(n_of)], 1).astype(np.int64)
            key = np.where(_rows_le(f, c)[:, None], f, c)
            key[~valid] = sent
            out[(r0 * wn + w0) + gl] = key
            step = ~sit_out
            sit_out = np.zeros(T, bool)
            wl, rl, p = (wl + step * (T % nw), rl + step * (T // nw),
                         p + step * (T // nw * row + T % nw))
            wrap = wl >= nw
            wl, rl, p = (np.where(wrap, wl - nw, wl), rl + wrap,
                         np.where(wrap, p + row - nw, p))
    return out


def _rows_le(a, b):
    """Lexicographic a <= b over the rows' words."""
    le, decided = np.ones(len(a), bool), np.zeros(len(a), bool)
    for i in range(a.shape[1]):
        diff = ~decided & (a[:, i] != b[:, i])
        le[diff] = a[diff, i] < b[diff, i]
        decided |= diff
    return le


def _plain(mat, lens, k, front_clip=0, end_clip=0):
    fn = (ext.extract_canonical_keys_torch if k <= 31
          else ext.extract_canonical_rows_torch)
    got = fn(torch.as_tensor(mat), torch.as_tensor(lens), k=k,
             front_clip=front_clip, end_clip=end_clip)
    return got.reshape(got.shape[0], -1).numpy()


def _edge_lengths(n, L, k, seed):
    """Lengths 0, k - 1, k, k + 1, L and L + 5 among random ones."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    edges = np.array([0, k - 1, k, k + 1, L, L + 5], np.int32)
    lens[: min(n, len(edges))] = edges[: n]
    return lens


@pytest.mark.parametrize("L,ks", [(100, range(1, 100)),
                                  (151, [31, 32, 62, 63, 93, 94]),
                                  (250, [21, 61, 95])])
@pytest.mark.parametrize("addr", [0, 1, 7, 15])
def test_kernel_model_matches_plain(L, ks, addr):
    """The kernel's stream arithmetic, played in numpy at every byte
    offset of the matrix, gives the plain version's keys at every k."""
    rng = np.random.default_rng(L + addr)
    for k in ks:
        R = 12 if k % 2 else 40
        mat = rng.integers(0, 4, (R, L), dtype=np.uint8)
        lens = _edge_lengths(R, L, k, seed=k)
        clips = (0, 0) if k % 3 else (3, 2)
        np.testing.assert_array_equal(
            _kernel_model(mat, lens, k, *clips, addr), _plain(mat, lens, k, *clips),
            err_msg=f"k={k}")


@pytest.mark.parametrize("L,k,stage", [(1000, 31, 300), (1000, 95, 300),
                                       (700, 62, 250), (130, 99, 128)])
def test_kernel_model_split_rows_match_plain(monkeypatch, L, k, stage):
    """Rows longer than the stage: a CTA per ``windows`` windows of one
    read, the last CTA of a read short."""
    monkeypatch.setattr(ext, "STAGE_BASES", stage)
    assert ext.launch_geometry(L, k).ctas_per_read > 1
    rng = np.random.default_rng(k)
    mat = rng.integers(0, 4, (3, L), dtype=np.uint8)
    lens = _edge_lengths(3, L, k, seed=1)
    lens[-1] = L
    np.testing.assert_array_equal(_kernel_model(mat, lens, k, 2, 1, 5),
                                  _plain(mat, lens, k, 2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [100, 101, 151, 250])
def test_extract_kernel_every_k_matches_plain(L):
    """Every k from 1 to 99 (both wrappers), with and without clips, at
    lengths 0, k - 1, k, k + 1, L, L + 5 and random ones."""
    dev = _card()
    rng = np.random.default_rng(L)
    for k in range(1, min(L, 99) + 1):
        mat = rng.integers(0, 4, (257, L), dtype=np.uint8)
        lens = _edge_lengths(257, L, k, seed=k)
        for clips in ((0, 0), (3, 2), (0, 7)):
            _check_kernel(dev, mat, lens, k, *clips)


def _check_kernel(dev, mat, lens, k, front_clip=0, end_clip=0, slice_from=0):
    """Launch on the card (the matrix from row ``slice_from`` of a copy
    on the card, so a row slice) and require the plain version's keys."""
    want = _plain(mat[slice_from:], lens[slice_from:], k, front_clip,
                  end_clip)
    fn = (ext.extract_canonical_keys if k <= 31
          else ext.extract_canonical_rows)
    m = torch.from_numpy(mat).to(dev)[slice_from:]
    ln = torch.from_numpy(lens).to(dev)[slice_from:]
    assert m.is_contiguous()
    got = fn(m, ln, k=k, front_clip=front_clip, end_clip=end_clip)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().reshape(len(want), -1).numpy(),
                                  want, err_msg=f"k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 17, 31, 32, 61, 62, 63, 93, 94, 99])
def test_extract_kernel_row_width_k(k):
    """L = k: one window per row."""
    dev = _card()
    rng = np.random.default_rng(k)
    mat = rng.integers(0, 4, (1000, k), dtype=np.uint8)
    lens = _edge_lengths(1000, k, k, seed=k)
    lens[10:] = k + 2
    _check_kernel(dev, mat, lens, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 61, 95])
@pytest.mark.parametrize("at", ["1", "RB-1", "RB", "RB+1", "3RB+5"])
def test_extract_kernel_read_block_edges(k, at):
    """R around the reads per CTA: the last CTA's ragged block."""
    dev = _card()
    L = 100
    rb = ext.launch_geometry(L, k).reads
    R = {"1": 1, "RB-1": rb - 1, "RB": rb, "RB+1": rb + 1,
         "3RB+5": 3 * rb + 5}[at]
    rng = np.random.default_rng(R)
    mat = rng.integers(0, 4, (R, L), dtype=np.uint8)
    _check_kernel(dev, mat, _edge_lengths(R, L, k, seed=R), k, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("L,k", [(101, 31), (101, 61), (151, 21), (99, 95),
                                 (4097, 81)])
@pytest.mark.parametrize("slice_from", [1, 3])
def test_extract_kernel_misaligned_row_slice(L, k, slice_from):
    """``mat[1:]`` at odd L is contiguous but not 16-byte aligned."""
    dev = _card()
    rng = np.random.default_rng(L + k)
    R = 700
    mat = rng.integers(0, 4, (R, L), dtype=np.uint8)
    _check_kernel(dev, mat, _edge_lengths(R, L, k, seed=k), k, 2, 3,
                  slice_from=slice_from)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4096, 16_384, 16_385, 40_000])
@pytest.mark.parametrize("k", [31, 95])
def test_extract_kernel_long_rows(L, k):
    """Long rows: four reads per CTA at 4096, one at 16,384, and split
    across CTAs above the stage."""
    dev = _card()
    rng = np.random.default_rng(L + k)
    mat = rng.integers(0, 4, (9, L), dtype=np.uint8)
    lens = _edge_lengths(9, L, k, seed=L)
    lens[6:] = [L, L - 1000, L // 2]
    _check_kernel(dev, mat, lens, k, 4, 2, slice_from=1)


@pytest.mark.cuda
@pytest.mark.parametrize("L,k,stage", [(1000, 31, 300), (1000, 95, 300),
                                       (700, 62, 250), (130, 99, 128)])
def test_extract_kernel_split_rows(monkeypatch, L, k, stage):
    """The split-row form at small sizes: a read's last CTA short."""
    dev = _card()
    monkeypatch.setattr(ext, "STAGE_BASES", stage)
    rng = np.random.default_rng(k)
    mat = rng.integers(0, 4, (50, L), dtype=np.uint8)
    _check_kernel(dev, mat, _edge_lengths(50, L, k, seed=2), k, 2, 1,
                  slice_from=1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 61])
def test_extract_kernel_reads_two_bits_of_each_byte(k):
    """Bytes above 3 give the keys of their low two bits."""
    dev = _card()
    rng = np.random.default_rng(k)
    mat = rng.integers(0, 4, (300, 101), dtype=np.uint8)
    lens = _edge_lengths(300, 101, k, seed=k)
    high = mat | (rng.integers(0, 64, mat.shape, dtype=np.uint8) << 2)
    fn = (ext.extract_canonical_keys if k <= 31
          else ext.extract_canonical_rows)
    got = fn(torch.from_numpy(high).to(dev), torch.from_numpy(lens).to(dev),
             k=k)
    np.testing.assert_array_equal(got.cpu().reshape(-1, len(word_bases(k)))
                                  .numpy(), _plain(mat, lens, k))


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



def _genome_reads(genome_bp, n_reads, L, seed, err=0.01):
    """Reads of L bases from both strands of a random genome, with
    substitutions, so k-mers repeat and some are weak."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome_bp, dtype=np.uint8)
    starts = rng.integers(0, genome_bp - L + 1, n_reads)
    reads = g[starts[:, None] + np.arange(L)]
    bad = rng.random(reads.shape) < err
    reads[bad] = rng.integers(0, 4, int(bad.sum()), dtype=np.uint8)
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    return g, reads


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 41])
def test_mercy_window_lookup_kernels_match_plain(k):
    """Mercy's per-window counts through the extraction and sort kernels
    equal the plain path's, and so do the tables."""
    from reflexiv_tpu_torch import count, mercy

    dev = _card()
    _g, reads = _genome_reads(20_000, 6000, 100, seed=k)
    mat = torch.from_numpy(reads).to(dev)
    lens = torch.full((len(reads),), 100, dtype=torch.int32, device=dev)
    keys, counts = count.count_kmers(mat, lens, k=k, min_cov=1, device=dev,
                                     plain=True)
    got = mercy.window_counts(mat, lens, keys, counts, k=k)
    want = mercy.window_counts(mat, lens, keys, counts, k=k, plain=True)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    assert int((got[0] == 1).sum()) > 0 and int((got[0] > 3).sum()) > 0
    table = mercy.mercy_kmer_table(mat, lens, k=k, min_cov=3, device=dev)
    plain = mercy.mercy_kmer_table(mat, lens, k=k, min_cov=3, device=dev,
                                   plain=True)
    assert all(torch.equal(a, b) for a, b in zip(table, plain))
    assert int((table[1] < 3).sum()) > 0     # mercy k-mers were rescued


@pytest.mark.cuda
def test_patching_device_map_matches_native(monkeypatch):
    """The patching map's device form gives the native hashed call's ten
    arrays, N reads and an N contig included."""
    from reflexiv_tpu_torch import patching
    from reflexiv_tpu_torch.contigs import revcomp_str

    dev = _card()
    g, reads = _genome_reads(30_000, 1, 100, seed=5)
    gs = "".join("ACGT"[c] for c in g)
    cuts = list(range(0, 30_001, 3000))
    contigs = [gs[max(0, a - 20):b] for a, b in zip(cuts, cuts[1:])]
    contigs = [revcomp_str(c) if i % 2 else c for i, c in enumerate(contigs)]
    contigs.append(contigs[0][:200] + "N" * 20 + contigs[2][:200])
    rng = np.random.default_rng(6)
    pairs = []
    for s in rng.integers(0, len(gs) - 300, 20_000):
        pairs.append((gs[s:s + 100], revcomp_str(gs[s + 200:s + 300])))
    pairs += [("N" * 100, "T" * 100), ("T" * 50 + "N" + "T" * 49, gs[:100])]
    monkeypatch.delenv("REFLEXIV_DEVICE_STAGES", raising=False)
    monkeypatch.delenv("REFLEXIV_NATIVE_PATCH", raising=False)
    want, wlen = patching.map_pairs(contigs, pairs, device=dev)
    monkeypatch.setenv("REFLEXIV_DEVICE_STAGES", "1")
    got, glen = patching.map_pairs(contigs, pairs, device=dev)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_, w)
        assert g_.dtype == w.dtype
    np.testing.assert_array_equal(glen, wlen)
    assert want[4].sum() > 1000
