"""The row sort's design (``csrc/radix_sort.cu``, steps 1-4) played in
numpy against the plain version, and the kernel against the plain version
on the card.

The CPU tests play the kernel's steps with the wrapper's plans and caps
(``lead_plan``, ``pass_plan``, ``WARP_CAP``, ``CTA_CAP``): the onesweep over
the leading word; the warp tie kernel window by window (its 128-bit head
mask, the runs it owns, the one long-run start it may hand on, the
difference bits, the bitonic network over (run, words)); the CTA kernel over the long runs (the end found by rounds of 32
probes, identity from the difference bits, the network over the words); and the oversized runs,
the identical ones filled and the mixed ones through ``pass_plan`` on their
compacted row ids, placed by the run table. Every output row must be
written exactly once, the scratch must fit the buffers the wrapper
allocates, and the result must equal ``sort_rows_torch``. This file imports
no jax:

    python -m pytest -q tests/test_torch_sort_rows.py
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sort_rows.py

Every comparison is exact (integer rows)."""
import numpy as np
import pytest
import torch

from reflexiv_tpu_torch.bitpack import word_bases
from reflexiv_tpu_torch.kernels import extract as ext
from reflexiv_tpu_torch.kernels import radix_sort

WARP = radix_sort.WARP_CAP          # also the warp's width: 32 positions
NO_RUN = 0xFFFFFFFF                 # an idle lane's tag
BLOCK_SMEM = 232_448                # shared memory an H100 block may take


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---- the model ----

def _play(rows, plan, ids=None):
    """Play a pass plan as the onesweep passes do: numpy stable sorts over
    8-bit digits, two buffers each of keys and indices, a pass reading only
    what the pass before it wrote; the first pass fetches through ``ids``
    where given. Returns (keys, idx, rows written by a WRITE_ROWS pass)."""
    n = rows.shape[0] if ids is None else len(ids)
    keys, idx, out, wrote = [None, None], [None, None], None, {}
    for p, (word, shift, key_src, idx_src, dst, flags) in enumerate(plan):
        if idx_src < 0:
            cur = np.arange(n) if ids is None else ids
        else:
            assert wrote.get(("idx", idx_src)) == p - 1
            cur = idx[idx_src]
        if key_src < 0:
            key = rows[cur, word]
        else:
            assert wrote.get(("key", key_src)) == p - 1
            key = keys[key_src]
        order = np.argsort((key >> shift) & 255, kind="stable")
        if flags & radix_sort.WRITE_ROWS:
            assert p == len(plan) - 1
            out = rows[cur[order]]
            continue
        if flags & radix_sort.WRITE_KEYS:
            keys[dst], wrote[("key", dst)] = key[order], p
        idx[dst], wrote[("idx", dst)] = cur[order], p
    return keys, idx, out


def _lex_less(a, b):
    """Columns ``a`` before columns ``b``, lexicographically, elementwise."""
    less = np.zeros(a[0].shape, bool)
    eq = np.ones(a[0].shape, bool)
    for x, y in zip(a, b):
        less |= eq & (x < y)
        eq &= x == y
    return less


def _bitonic(cols, n_keys):
    """The kernels' bitonic network over a batch: ``cols`` are (B, N)
    arrays, N a power of two, compared on the first ``n_keys``; the pair
    (i, i + j) of a block with ``i & k == 0`` keeps the smaller at i, the
    others the larger; equal elements stay. (The warp's lanes decide a tie
    each on its own, which holds because its elements are all key.)"""
    cols = [c.copy() for c in cols]
    N = cols[0].shape[1]
    i = np.arange(N)
    k = 2
    while k <= N:
        j = k // 2
        while j:
            lo = i[(i & j) == 0]
            hi = lo + j
            a = [c[:, lo] for c in cols]
            b = [c[:, hi] for c in cols]
            swap = np.where((lo & k) == 0, _lex_less(b[:n_keys], a[:n_keys]),
                            _lex_less(a[:n_keys], b[:n_keys]))
            for c, x, y in zip(cols, a, b):
                c[:, lo] = np.where(swap, y, x)
                c[:, hi] = np.where(swap, x, y)
            j //= 2
        k *= 2
    return cols


def _prev(H, i):
    """Highest set bit <= i of a 128-bit head mask, or -1."""
    return (H & ((2 << i) - 1)).bit_length() - 1


def _next(H, i):
    """Lowest set bit > i, or 128."""
    m = H >> (i + 1)
    return 128 if m == 0 else i + (m & -m).bit_length()


def _run_end(K0, s):
    """The CTA kernel's search for the end of a long run: rounds of 32
    probes (one warp) at a stride growing 32-fold, then shrinking."""
    n, key = len(K0), K0[s]
    lo, stride, grow, rounds = s + WARP, 1, True, 0
    lanes = np.arange(1, 33)
    while True:
        rounds += 1
        assert rounds <= 16
        p = lo + stride * lanes
        past = (p >= n) | (K0[np.minimum(p, n - 1)] != key)
        if not past.any():
            lo += 32 * stride
            if grow:
                stride *= 32
            continue
        grow = False
        lo += stride * int(np.argmax(past))
        if stride == 1:
            return lo + 1
        stride //= 32


def _run_table(runs):
    """(start, offset) pairs and the closing (0, total), flattened."""
    table, off = [], 0
    for s, length in runs:
        table += [s, off]
        off += length
    return np.array(table + [0, off], np.int64), off


def _run_position(table, j):
    """Position of element j of the flattened runs (the kernels' search)."""
    starts, offs = table[0::2], table[1::2]
    r = np.searchsorted(offs[:-1], j, side="right") - 1
    return starts[r] + j - offs[r]


def model_sort_rows(rows, last_bits, cap=None):
    """The kernel's four steps on (n, W) int64 rows; returns the sorted
    rows and the count of runs each step took."""
    cap = radix_sort.CTA_CAP if cap is None else cap
    n, W = rows.shape
    stats = dict(warp=0, cta=0, same=0, oversized=0)
    # scratch the kernel places in the second key buffer (2n uint32)
    windows = -(-n // 32)
    assert windows + n // (WARP + 1) + 3 * (n // (cap + 1)) <= 2 * n
    # 1. the leading word
    lead = radix_sort.lead_plan()
    keys, idx, _ = _play(rows, lead)
    assert lead[-1, 4] == 0 and lead[-1, 5] & radix_sort.WRITE_KEYS
    K0, I0 = keys[0], idx[0]
    tails = rows[:, 1:].view(np.uint64)
    out = np.full_like(rows, -1)
    written = np.zeros(n, np.int64)

    # 2-3. the warp tie kernel, window by window
    head = np.ones(32 * (windows + 3), bool)    # position p at p + 32
    head[:32] = False
    head[33:32 + n] = K0[1:] != K0[:-1]
    words = np.packbits(head, bitorder="little").view("<u4")
    diff = np.zeros(32 * windows, bool)
    long_starts, batches = [], {1: [], 2: []}
    for w in range(windows):
        base = 32 * w
        H = sum(int(words[w + c]) << (32 * c) for c in range(4))
        if base - 32 != 0:
            H &= ~1                             # chunk 0's lane 0
        for lane in range(min(32, n - base)):
            p = base + lane
            start = _prev(H, lane + 32)
            in_long = start < lane + 1 or _next(H, lane + 32) - start > WARP
            if in_long and not (H >> (lane + 32)) & 1:
                diff[p] = (rows[I0[p], 1:] != rows[I0[p - 1], 1:]).any()
        starts = (H >> 32) & ((1 << min(32, n - base)) - 1)
        if not starts:
            continue
        a = (starts & -starts).bit_length() - 1
        last = starts.bit_length() - 1
        after = _next(H, last + 32) - 32
        b = after
        if after - last > WARP:
            b = last
            long_starts.append(base + last)
        span = b - a
        assert 0 <= span <= 2 * 32 - 1 and base + b <= n
        if span == 0:
            continue
        R = 2 if span > 32 else 1
        tag = np.full(32 * R, NO_RUN, np.uint64)
        tl = np.full((32 * R, W - 1), ~np.uint64(0))
        for e in range(span):
            tag[e] = _prev(H, a + e + 32)
            tl[e] = tails[I0[base + a + e]]
        stats["warp"] += bin(starts).count("1") - (b == last)
        batches[R].append((base + a, span, tag, tl))
    for R, got in batches.items():
        if not got:
            continue
        cols = [np.stack([g[2] for g in got])] + [
            np.stack([g[3][:, c] for g in got]) for c in range(W - 1)]
        cols = _bitonic(cols, W)
        for i, (first, span, _tag, _tl) in enumerate(got):
            pos = first + np.arange(span)
            out[pos, 0] = K0[pos]
            for c in range(W - 1):
                out[pos, 1 + c] = cols[1 + c][i, :span].view(np.int64)
            written[pos] += 1
    assert len(long_starts) <= n // (WARP + 1)

    # 3b. the CTA kernel over the long runs
    assert 8 * (W - 1) * cap + (2 * cap if W > 2 else 0) <= BLOCK_SMEM
    oversized = []
    for s in long_starts:
        e = _run_end(K0, s)
        mixed = bool(diff[s + 1:e].any())
        if e - s > cap:
            oversized.append((s, e - s, mixed))
            continue
        stats["cta"] += 1
        if not mixed:
            out[s:e] = rows[I0[s]]
            written[s:e] += 1
            continue
        m = e - s
        size = 2 * WARP
        while size < m:
            size *= 2
        assert size <= cap or cap < radix_sort.CTA_CAP
        # all-ones padding sorts after every row; the network compares
        # word 1, then (W > 2) the other words through the slots
        tcols = [np.full((1, size), ~np.uint64(0)) for _ in range(W - 1)]
        for c in range(W - 1):
            tcols[c][0, :m] = tails[I0[s:e], c]
        got = _bitonic(tcols, W - 1)
        out[s:e, 0] = K0[s]
        out[s:e, 1:] = np.stack([g[0, :m] for g in got], 1).view(np.int64)
        written[s:e] += 1
    assert len(oversized) <= n // (cap + 1)

    # 4. the oversized runs, in position order
    oversized.sort()
    same = [(s, m) for s, m, mixed in oversized if not mixed]
    mixed = [(s, m) for s, m, is_mixed in oversized if is_mixed]
    stats["same"], stats["oversized"] = len(same), len(mixed)
    same_table, n_same = _run_table(same)
    mixed_table, n_mixed = _run_table(mixed)
    if oversized:                     # both tables in keys[0]
        assert len(same_table) + len(mixed_table) <= 2 * n
    if n_same:
        j = np.arange(n_same)
        pos = _run_position(same_table, j)
        first = same_table[0::2][np.searchsorted(same_table[1::2][:-1], j,
                                                 side="right") - 1]
        out[pos] = rows[I0[first]]
        written[pos] += 1
    if n_mixed:
        ids = I0[_run_position(mixed_table, np.arange(n_mixed))]
        plan = radix_sort.pass_plan(W, last_bits)
        assert plan[-1, 2] == 1       # the last pass leaves keys[0] free
        _k, _i, got = _play(rows, plan, ids)
        pos = _run_position(mixed_table, np.arange(n_mixed))
        out[pos] = got
        written[pos] += 1
    assert (written == 1).all()
    return out, stats


# ---- inputs ----

def _tails(rng, n, W, last_bits):
    t = rng.integers(0, 1 << 62, (n, W - 1), dtype=np.int64)
    t[:, -1] &= (1 << last_bits) - 1
    return t


def _runs_of(lengths, W, last_bits, rng, identical=()):
    """One run of each length, each its own word 0 (ascending with the
    run), mixed suffixes unless its index is in ``identical``; shuffled."""
    n = int(sum(lengths))
    rows = np.empty((n, W), np.int64)
    w0 = np.sort(rng.choice(1 << 40, len(lengths), replace=False))
    at = 0
    for r, m in enumerate(lengths):
        rows[at:at + m, 0] = w0[r]
        rows[at:at + m, 1:] = _tails(rng, 1 if r in identical else m, W,
                                     last_bits)
        at += m
    return rows[rng.permutation(n)]


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
    return rows


def _k_of(W, last_bits):
    return 31 * (W - 1) + last_bits // 2


def adversarial_rows(case, W, n, last_bits, seed):
    """The design's hard inputs, about n rows of W words whose last word
    holds ``last_bits`` bits (even: whole bases)."""
    rng = np.random.default_rng(seed)
    cap = radix_sort.CTA_CAP
    if case == "run_lengths":       # 1, 32, 33, cap and cap + 1, and more
        lengths = [1, WARP, WARP + 1, cap, cap + 1, 2, WARP - 1, 63, 64]
        while sum(lengths) > n:
            lengths.remove(max(lengths))
        lengths += list(rng.integers(1, 12, max(0, n - sum(lengths)) // 6))
        return _runs_of(lengths, W, last_bits, rng, identical={1, 4})
    if case == "one_run":           # every row one word 0, distinct suffixes
        rows = np.empty((n, W), np.int64)
        rows[:, 0] = 12345
        rows[:, 1:] = _tails(rng, n, W, last_bits)
        return rows
    if case == "identical":
        return np.repeat(rng.integers(0, 1 << 40, (1, W)), n, axis=0)
    if case == "sentinel_quarter":  # the poly-T tail at 1/4 of n
        rows = _counting_rows(_k_of(W, last_bits), n, seed)
        rows[rows[:, 0] == ext.sentinel(_k_of(W, last_bits))[0]] = \
            rng.integers(0, 1 << 40, W)
        rows[rng.permutation(n)[: n // 4]] = ext.sentinel(_k_of(W, last_bits))
        return rows
    if case == "distinct_lead":     # every leading word distinct
        rows = np.empty((n, W), np.int64)
        rows[:, 0] = rng.choice(1 << 60, n, replace=False)
        rows[:, 1:] = _tails(rng, n, W, last_bits)
        return rows
    if case == "mixed_runs":        # runs of 100-8,000 rows, none identical
        lengths = []
        while sum(lengths) < n:
            lengths.append(int(rng.integers(100, 8001)))
        lengths[-1] -= sum(lengths) - n
        return _runs_of(lengths, W, last_bits, rng)
    if case == "many_oversized":    # runs over the cap, identical and mixed,
        # between short ones (n is not used: 36,422 rows)
        lengths = [cap + 1, cap + 900, 40, cap + 8, 5, cap + 2000, 700]
        return _runs_of(lengths, W, last_bits, rng, identical={2, 3})
    if case == "near_ties":         # short runs differing only in the last bits
        lengths = list(rng.integers(1, 40, n // 20))
        rows = _runs_of(lengths, W, last_bits, rng)
        rows[:, -1] &= 3
        return rows
    raise ValueError(case)


CASES = ("run_lengths", "one_run", "identical", "sentinel_quarter",
         "distinct_lead", "mixed_runs", "near_ties")


# ---- CPU: the model against the plain version ----

def _check_model(rows, last_bits):
    want = radix_sort.sort_rows_torch(torch.from_numpy(rows)).numpy()
    got, stats = model_sort_rows(rows, last_bits)
    np.testing.assert_array_equal(got, want)
    return stats


def test_lead_plan_sorts_by_the_leading_word():
    """8 passes of word 0 carrying the index; played, they give a stable
    order by word 0 in buffer 0."""
    plan = radix_sort.lead_plan()
    assert plan.shape == (8, 6) and plan.dtype == np.int32
    assert (plan[:, 0] == 0).all() and (plan[:, 5] == radix_sort.WRITE_KEYS).all()
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 1 << 62, (500, 3), dtype=np.int64)
    rows[::4, 0] = rows[0, 0]
    keys, idx, _ = _play(rows, plan)
    order = np.argsort(rows[:, 0], kind="stable")
    np.testing.assert_array_equal(idx[0], order)
    np.testing.assert_array_equal(keys[0], rows[order, 0])


def test_caps_fit_the_kernel():
    """The warp cap is the warp's width; the CTA cap is a power of two
    (the network's largest padded size) whose rows (W - 1 words and a
    16-bit slot each) fit a block's shared memory at W = 4, and twice as
    many would not."""
    cap = radix_sort.CTA_CAP
    assert WARP == 32
    assert cap & (cap - 1) == 0 and cap > 2 * WARP and cap <= 0xFFFF
    assert 26 * cap <= BLOCK_SMEM < 26 * 2 * cap


def test_bitonic_model_sorts_any_batch():
    rng = np.random.default_rng(2)
    for N in (32, 64, 8192):
        a = rng.integers(0, 5, (3, N)).astype(np.uint64)
        b = rng.integers(0, 1 << 62, (3, N)).astype(np.uint64)
        got = _bitonic([a, b], 2)
        for r in range(3):
            order = np.lexsort((b[r], a[r]))
            np.testing.assert_array_equal(got[0][r], a[r][order])
            np.testing.assert_array_equal(got[1][r], b[r][order])


@pytest.mark.parametrize("k", [41, 61, 81, 95])
def test_model_counting_rows(k):
    """Counting rows: a 30% sentinel tail and a shared leading word, each
    over the cap at 40,000 rows, so every step runs."""
    rows = _counting_rows(k, 40_000, seed=k)
    stats = _check_model(rows, 2 * word_bases(k)[-1])
    assert stats["same"] >= 1 and stats["oversized"] >= 1 and \
        stats["warp"] + stats["cta"] >= 1


@pytest.mark.parametrize("W", [2, 3, 4])
@pytest.mark.parametrize("case", CASES)
def test_model_adversarial(case, W):
    n = {"one_run": 2 * radix_sort.CTA_CAP + 5,
         "identical": radix_sort.CTA_CAP + 100}.get(case, 24_000)
    last_bits = {2: 60, 3: 38, 4: 2}[W]
    rows = adversarial_rows(case, W, n, last_bits, seed=W)
    stats = _check_model(rows, last_bits)
    if case == "one_run":
        assert stats["oversized"] == 1
    if case == "identical":
        assert stats["same"] == 1
    if case == "run_lengths":
        assert stats["cta"] >= 2 and stats["same"] + stats["oversized"] >= 1
    if case == "mixed_runs":
        assert stats["cta"] >= 3 and stats["oversized"] == 0


def test_model_many_oversized_runs():
    """Runs over the cap, identical and mixed, between short ones: both
    run tables of step 4 hold several runs."""
    rows = adversarial_rows("many_oversized", 3, 0, 38, seed=3)
    stats = _check_model(rows, 38)
    assert stats["oversized"] == 3 and stats["same"] == 1


@pytest.mark.parametrize("last_bits", [2, 38, 60])
@pytest.mark.parametrize("W", [2, 3, 4])
def test_model_last_word_widths(W, last_bits):
    """Short runs whose rows differ in the last word's top bits only."""
    rng = np.random.default_rng(W * last_bits)
    rows = _runs_of(list(rng.integers(1, 70, 300)), W, last_bits, rng)
    _check_model(rows, last_bits)


def test_model_small_inputs():
    """Fewer rows than a warp's window, and exactly one window."""
    for n in (1, 2, 31, 32, 33, 95, 96, 97):
        for W, last_bits in ((2, 60), (4, 2)):
            rng = np.random.default_rng(n)
            rows = _runs_of([1] * (n // 3) + [n - n // 3], W, last_bits, rng) \
                if n > 3 else adversarial_rows("distinct_lead", W, n,
                                               last_bits, seed=n)
            _check_model(rows, last_bits)


def test_model_small_cap_takes_the_row_plan():
    """With a cap of 40, runs of 41-100 rows take step 4: many oversized
    runs, identical and mixed, placed through one run table."""
    rng = np.random.default_rng(7)
    lengths = list(rng.integers(1, 100, 400))
    rows = _runs_of(lengths, 3, 38, rng, identical=set(range(0, 400, 5)))
    want = radix_sort.sort_rows_torch(torch.from_numpy(rows)).numpy()
    got, stats = model_sort_rows(rows, 38, cap=40)
    np.testing.assert_array_equal(got, want)
    assert stats["oversized"] > 50 and stats["same"] > 5


# ---- the card: the kernel against the plain version ----

def _on_card(rows, last_bits):
    dev = _card()
    t = torch.from_numpy(rows)
    W = rows.shape[1]
    before = radix_sort.ROW_LAUNCHES.get(W, 0)
    got = radix_sort.sort_rows(t.to(dev), last_bits=last_bits)
    torch.cuda.synchronize()
    assert radix_sort.ROW_LAUNCHES[W] == before + 1
    assert torch.equal(got.cpu(), radix_sort.sort_rows_torch(t))


def _tile():
    from reflexiv_tpu_torch.kernels import build

    return build.lib().rfx_radix_sort_tile(1)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 3, 4])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("at", ["tile-1", "tile+1", "5tiles+1", "3caps"])
def test_sort_rows_kernel_adversarial(case, W, at):
    _card()
    tile = _tile()
    n = {"tile-1": tile - 1, "tile+1": tile + 1, "5tiles+1": 5 * tile + 1,
         "3caps": 3 * radix_sort.CTA_CAP + 7}[at]
    last_bits = {2: 60, 3: 38, 4: 2}[W]
    _on_card(adversarial_rows(case, W, n, last_bits, seed=n + W), last_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [41, 61, 81, 95])
@pytest.mark.parametrize("n", [1, 31, 33, 97, 40_000])
def test_sort_rows_kernel_counting_rows(k, n):
    _card()
    _on_card(_counting_rows(k, n, seed=k + n), 2 * word_bases(k)[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 3, 4])
def test_sort_rows_kernel_one_run_of_2p20_rows(W):
    """One leading word, 2^20 distinct suffixes: the row plan on every
    row."""
    _card()
    last_bits = {2: 60, 3: 38, 4: 2}[W]
    _on_card(adversarial_rows("one_run", W, 1 << 20, last_bits, seed=W),
             last_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 3, 4])
def test_sort_rows_kernel_all_identical_2p24_rows(W):
    dev = _card()
    row = torch.tensor([(1 << 61) + 77 * c for c in range(W)],
                       dtype=torch.int64, device=dev)
    rows = row.repeat(1 << 24, 1)
    before = radix_sort.ROW_LAUNCHES.get(W, 0)
    got = radix_sort.sort_rows(rows, last_bits=62)
    torch.cuda.synchronize()
    assert radix_sort.ROW_LAUNCHES[W] == before + 1
    assert torch.equal(got, radix_sort.sort_rows_torch(rows))


@pytest.mark.cuda
def test_tie_caps_are_the_kernels():
    """The caps the model plays with are the ones the kernel was built
    with."""
    _card()
    from reflexiv_tpu_torch.kernels import build

    assert build.lib().rfx_radix_sort_tie_cap(0) == radix_sort.WARP_CAP
    assert build.lib().rfx_radix_sort_tie_cap(1) == radix_sort.CTA_CAP


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 3, 4])
def test_sort_rows_kernel_many_oversized_runs(W):
    """Several runs over the cap, identical and mixed, between short ones:
    step 4's run tables with more than one run each."""
    _card()
    last_bits = {2: 60, 3: 38, 4: 2}[W]
    rows = adversarial_rows("many_oversized", W, 0, last_bits, seed=W)
    _on_card(rows, last_bits)
