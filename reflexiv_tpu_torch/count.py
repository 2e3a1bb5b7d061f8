"""Canonical k-mer counting (PyTorch counterpart of ``reflexiv_tpu.count``).

extract -> sort -> run-length count -> coverage band, the counterpart of
``count_pass_fused`` / ``sort_count_filter`` / ``_runlength_keep``
(``count.py:150-303``) and of the reference's ``groupBy("value").count()``
with coverage filters (``ReflexivDataFrameCounter.java:207-216``).

The table is ``(keys, counts)``: unique canonical keys ascending and int32
counts, on the device. Keys are ``(U,)`` int64 for k <= 31 and ``(U, W)``
int64 word rows for 32 <= k <= 99 (``bitpack``); ``bitpack.limbs_from_keys``
turns either into the JAX package's ``(U, ceil(k/16))`` limb array, row for
row.

Inputs too large for one pass stream (``count.count_kmers_streaming``):
each chunk of reads is counted by the same kernels into a unique table,
merged into a running table that stays on the device, and the coverage
band is applied once at the end. :func:`count_kmers_auto` streams row
chunks of an in-memory matrix past :data:`STREAM_WINDOW_LIMIT` windows or
under ``-partition``; :func:`count_kmers_from_files` and
:func:`count_kmers_from_files_multi` stream chunks from disk under
``REFLEXIV_INGEST_BUDGET_MB`` (host memory about one chunk plus the
table). A running table past :func:`_device_table_rows_limit` rows spills
to host memory and the host merges the segments at the end. Every form
gives the one-pass table exactly.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from . import metrics
from .bitpack import check_k, num_words, rows_equal, searchsorted_rows, \
    word_bases
from .device import resolve_device
from .kernels import extract as extract_mod
from .kernels import radix_sort

log = logging.getLogger("reflexiv_tpu_torch")

# windows of one counting pass at one word per key (W words: 1/W of it):
# the pass's keys, the sort's two buffers and the run boundaries take
# about 34 GB at this size, well inside an 80 GB card, and the radix
# sort's 32-bit offsets (radix_sort.MAX_N) bound it in any case
STREAM_WINDOW_LIMIT = 1 << 30
COUNT_MAX = 2**31 - 1   # counts saturate here, as the JAX package's


def _as_device(x, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) \
        else x
    return t.to(device=device, dtype=dtype).contiguous()


def runlength_band(skeys: torch.Tensor, sentinel, min_cov: int,
                   max_cov: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted ``(N,)`` keys or ``(N, W)`` rows (sentinels at the tail) ->
    unique keys whose run length lies in ``[min_cov, max_cov]``, with those
    lengths as int32."""
    is_sent = skeys == torch.as_tensor(sentinel, device=skeys.device)
    n_valid = skeys.shape[0] - int(
        (is_sent.all(-1) if skeys.dim() == 2 else is_sent).sum())
    del is_sent
    valid = skeys[:n_valid]
    if n_valid == 0:
        return valid, torch.zeros(0, dtype=torch.int32, device=skeys.device)
    is_start = torch.ones(n_valid, dtype=torch.bool, device=skeys.device)
    diff = valid[1:] != valid[:-1]
    is_start[1:] = diff.any(-1) if valid.dim() == 2 else diff
    del diff
    starts = torch.nonzero(is_start).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([n_valid])])
    counts = ends - starts
    keep = (counts >= min_cov) & (counts <= max_cov)
    return valid[starts[keep]], counts[keep].to(torch.int32)


def count_kmers(
    bases,
    lengths,
    *,
    k: int,
    min_cov: int,
    max_cov: int = 10_000_000,
    front_clip: int = 0,
    end_clip: int = 0,
    device,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reads -> (unique canonical keys, counts) on ``device``; keys are
    ``(U,)`` for k <= 31 and ``(U, W)`` word rows above.

    ``bases`` is a ``(R, L)`` uint8 code matrix and ``lengths`` ``(R,)``
    (numpy or tensors). On a CUDA device the extraction and the sort are
    the hand kernels; ``plain=True`` runs their plain torch versions
    instead (the reference the card's kernels are checked against).

    One pass takes fewer than 2^31 windows (the sort's 32-bit offsets);
    :func:`count_kmers_auto` takes any size."""
    check_k(k)
    device = resolve_device(device)
    R, L = bases.shape
    n_windows = R * max(L - k + 1, 0)
    if n_windows > radix_sort.MAX_N:
        raise ValueError(f"{n_windows} k-mer windows exceed the 2^31 "
                         "single-pass bound; count_kmers_auto streams them")
    keys = extract_windows(
        _as_device(bases, torch.uint8, device),
        _as_device(lengths, torch.int32, device), k=k,
        front_clip=front_clip, end_clip=end_clip, plain=plain)
    skeys = sort_windows(keys, k, plain=plain)
    del keys
    return runlength_band(skeys, extract_mod.sentinel(k), min_cov, max_cov)


def extract_windows(b: torch.Tensor, lens: torch.Tensor, *, k: int,
                    front_clip: int = 0, end_clip: int = 0,
                    plain: bool = False) -> torch.Tensor:
    """Canonical key of every read window (the sentinel where invalid):
    ``(R * (L-k+1),)`` keys or ``(R * (L-k+1), W)`` rows, through the
    extraction kernel or, with ``plain``, its plain version."""
    clips = dict(k=k, front_clip=front_clip, end_clip=end_clip)
    if num_words(k) == 1:
        fn = extract_mod.extract_canonical_keys_torch if plain \
            else extract_mod.extract_canonical_keys
    else:
        fn = extract_mod.extract_canonical_rows_torch if plain \
            else extract_mod.extract_canonical_rows
    return fn(b, lens, **clips)


def sort_windows(keys: torch.Tensor, k: int, *,
                 plain: bool = False) -> torch.Tensor:
    """:func:`extract_windows`' keys sorted, through the radix sort or,
    with ``plain``, its plain version."""
    if num_words(k) == 1:
        return radix_sort.sort_keys_torch(keys) if plain \
            else radix_sort.sort_keys(keys, bits=2 * k)
    return radix_sort.sort_rows_torch(keys) if plain \
        else radix_sort.sort_rows(keys, last_bits=2 * word_bases(k)[-1])


def merge_count_tables(
    keys_a: torch.Tensor, counts_a: torch.Tensor,
    keys_b: torch.Tensor, counts_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted unique (key, count) tables (``(U,)`` keys or
    ``(U, W)`` rows) into one, summing the counts of shared keys and
    saturating at 2^31 - 1 (``count.merge_count_tables``).

    A merge path, no sort: each row of ``b`` finds its place in ``a`` by
    binary search; a row found there adds its count, and the rest are
    scattered between ``a``'s rows, each ``a`` row moving up by the new
    rows before it."""
    na, nb = keys_a.shape[0], keys_b.shape[0]
    if na == 0 or nb == 0:
        keys, counts = (keys_b, counts_b) if na == 0 else (keys_a, counts_a)
        return keys, counts.to(torch.int32)
    pos = (torch.searchsorted(keys_a, keys_b) if keys_a.dim() == 1
           else searchsorted_rows(keys_a, keys_b))
    hit = rows_equal(keys_a[pos.clamp(max=na - 1)], keys_b) & (pos < na)
    counts = counts_a.to(torch.int32).clone()
    at = pos[hit]
    counts[at] = (counts[at].to(torch.int64) + counts_b[hit]).clamp(
        max=COUNT_MAX).to(torch.int32)
    new = ~hit
    del hit
    at = pos[new]
    del pos
    n_new = at.shape[0]
    dev = keys_a.device
    moved = torch.cumsum(torch.bincount(at, minlength=na + 1)[:na], 0)
    moved += torch.arange(na, device=dev)
    keys = keys_a.new_empty((na + n_new,) + tuple(keys_a.shape[1:]))
    out_counts = counts.new_empty(na + n_new)
    keys[moved] = keys_a
    out_counts[moved] = counts
    del moved, counts
    at += torch.arange(n_new, device=dev)
    keys[at] = keys_b[new]
    out_counts[at] = counts_b[new].to(torch.int32)
    return keys, out_counts


def pass_rows(R: int, L: int, k: int, partitions: int = 0) -> int:
    """Rows of ``L`` bases one counting pass takes: ``STREAM_WINDOW_LIMIT //
    W`` windows' worth, and at most ``ceil(R / partitions)`` under
    ``-partition``."""
    limit = min(STREAM_WINDOW_LIMIT // num_words(k), radix_sort.MAX_N)
    rows = max(1, limit // max(L - k + 1, 1))
    return max(1, min(rows, -(-R // partitions))) if partitions > 1 else rows


def count_kmers_auto(bases, lengths, *, k: int, min_cov: int,
                     max_cov: int = 10_000_000, front_clip: int = 0, end_clip: int = 0,
                     partitions: int = 0, device, plain: bool = False):
    """One :func:`count_kmers` pass when the matrix has at most
    ``STREAM_WINDOW_LIMIT // W`` windows, else :func:`count_kmers_streaming`
    over row chunks of that many windows (``dynamic.count_kmers_auto``).
    ``partitions`` > 1 (``-partition``) streams in chunks of
    ``ceil(R / partitions)`` rows at most, whatever the size. The table is
    the same either way."""
    R, L = bases.shape
    clips = dict(k=k, min_cov=min_cov, max_cov=max_cov,
                 front_clip=front_clip, end_clip=end_clip, device=device,
                 plain=plain)
    rows = pass_rows(R, L, k, partitions)
    if partitions <= 1 and rows >= R:
        return count_kmers(bases, lengths, **clips)
    return count_kmers_streaming(
        ((bases[lo:lo + rows], lengths[lo:lo + rows])
         for lo in range(0, R, rows)), **clips)


# ---------------------------------------------------------------------------
# streaming and spill
# ---------------------------------------------------------------------------

class _PrefetchedChunks:
    """Pull a chunk iterator through a daemon thread and a bounded queue,
    so host ingest (reading, parsing, 2-bit packing) overlaps the device's
    count and merge of the previous chunk (``count._PrefetchedChunks``).
    ``ingest_s`` sums the time the producer spent making chunks, not the
    time it waited on a full queue. An exception in the producer is raised
    in the consumer."""

    _DONE = object()

    def __init__(self, it, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.ingest_s = 0.0
        self._exc = None

        def run():
            try:
                t0 = time.perf_counter()
                for item in it:
                    self.ingest_s += time.perf_counter() - t0
                    self._q.put(item)
                    t0 = time.perf_counter()
            except BaseException as e:   # noqa: BLE001 - raised below
                self._exc = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, name="reflexiv-ingest",
                                        daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._exc is not None:
                    raise self._exc
                return
            yield item


def _maybe_prefetch(it):
    """``it`` through the prefetch thread, unless ``REFLEXIV_PREFETCH=0``
    (the serial loop)."""
    if os.environ.get("REFLEXIV_PREFETCH", "1") == "0":
        return it
    return _PrefetchedChunks(it)


def _device_table_rows_limit(W: int, device: torch.device,
                             tables: int = 1) -> int:
    """Rows a running table may hold on ``device`` before it spills to
    host memory (``count._device_table_rows_limit``).

    ``REFLEXIV_DEVICE_TABLE_ROWS`` sets it. Otherwise, on a card, each of
    the ``tables`` running tables (one per k of a ladder) may take an
    eighth of the card's memory divided among them, at ``8 W + 4`` bytes
    a row: a merge holds the table, its successor and two int64 index
    arrays, so its transient stays under half of the card beside the
    chunk's counting pass. An 80 GB card keeps 833M one-word rows. On the
    CPU the table already lives in host memory: no limit."""
    env = os.environ.get("REFLEXIV_DEVICE_TABLE_ROWS")
    if env:
        return int(env)
    if device.type != "cuda":
        return np.iinfo(np.int64).max
    total = torch.cuda.get_device_properties(device).total_memory
    return max(1, total // (8 * tables * (8 * W + 4)))


def empty_table(k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (keys, counts) table with no rows."""
    W = num_words(k)
    return (torch.zeros((0,) if W == 1 else (0, W), dtype=torch.int64,
                        device=device),
            torch.zeros(0, dtype=torch.int32, device=device))


class _RunningTable:
    """One k's running (keys, counts) table on the device: chunks' tables
    merge in, and past the row limit the table spills to host memory as a
    sorted segment and starts again. :meth:`finish` merges the segments on
    the host and applies the coverage band once."""

    def __init__(self, k: int, device: torch.device, tables: int = 1):
        self.k, self.device = k, device
        self.cap = _device_table_rows_limit(num_words(k), device, tables)
        self.keys = self.counts = None
        self.spilled = []

    def add(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        if self.keys is None:
            self.keys, self.counts = keys, counts
        else:
            self.keys, self.counts = merge_count_tables(
                self.keys, self.counts, keys, counts)
        if self.keys.shape[0] > self.cap:
            self.spilled.append((self.keys.cpu(), self.counts.cpu()))
            self.keys = self.counts = None
            metrics.current().add("count.spills")
            log.info("counting k=%d: spilled a %d-row table segment to the "
                     "host (%d segments)", self.k, len(self.spilled[-1][1]),
                     len(self.spilled))

    def finish(self, min_cov: int, max_cov: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.spilled:
            if self.keys is not None:
                self.spilled.append((self.keys.cpu(), self.counts.cpu()))
            # fold the host segments pairwise (``count._host_merge_parts``
            # sorts them all at once): log2(segments) rounds of merges
            parts = self.spilled
            while len(parts) > 1:
                parts = [merge_count_tables(*parts[i], *parts[i + 1])
                         if i + 1 < len(parts) else parts[i]
                         for i in range(0, len(parts), 2)]
            keys, counts = (t.to(self.device) for t in parts[0])
            self.spilled = []
        elif self.keys is not None:
            keys, counts = self.keys, self.counts
        else:
            keys, counts = empty_table(self.k, self.device)
        self.keys = self.counts = None
        metrics.current().set(f"count.table_rows_k{self.k}", counts.shape[0])
        band = (counts >= min_cov) & (counts <= max_cov)
        return keys[band], counts[band]


def _count_chunk(bases, lengths, *, k: int, front_clip: int, end_clip: int,
                 device, plain: bool):
    """One chunk's unique table before the band (``count
    ._count_chunk_device``): :func:`count_kmers` with min_cov 1, so the hand
    kernels on a card and their plain versions with ``plain`` or on the
    CPU."""
    return count_kmers(bases, lengths, k=k, min_cov=1, max_cov=COUNT_MAX,
                       front_clip=front_clip, end_clip=end_clip,
                       device=device, plain=plain)


def _stream(chunks, klist, *, min_cov: int, max_cov: int, front_clip: int,
            end_clip: int, device, plain: bool
            ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Count every chunk for every k into one running table per k. Each
    chunk goes to the device once. Times the loop into
    ``count.input_stall_s`` (waiting on the input) and
    ``count.device_loop_s`` (upload, count, merge), and, when ``chunks``
    comes through the prefetch thread, its work into ``count.ingest_s``."""
    device = resolve_device(device)
    for k in klist:
        check_k(k)
    met = metrics.current()
    tables = {k: _RunningTable(k, device, len(klist)) for k in klist}
    src = iter(chunks)
    while True:
        t0 = time.perf_counter()
        try:
            bases, lengths = next(src)
        except StopIteration:
            break
        t1 = time.perf_counter()
        met.add_time("count.input_stall_s", t1 - t0)
        met.add("count.chunks")
        b = _as_device(bases, torch.uint8, device)
        lens = _as_device(lengths, torch.int32, device)
        for k in klist:
            if b.shape[1] >= k:
                tables[k].add(*_count_chunk(
                    b, lens, k=k, front_clip=front_clip, end_clip=end_clip,
                    device=device, plain=plain))
        del b, lens
        met.add_time("count.device_loop_s", time.perf_counter() - t1)
    if isinstance(chunks, _PrefetchedChunks):
        met.add_time("count.ingest_s", chunks.ingest_s)
    return {k: t.finish(min_cov, max_cov) for k, t in tables.items()}


def count_kmers_streaming(
    chunks: Iterable, *, k: int, min_cov: int, max_cov: int = 10_000_000,
    front_clip: int = 0, end_clip: int = 0, device, plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bases, lengths)`` chunks -> the (keys, counts) table of all of
    them on ``device`` (``count.count_kmers_streaming``, which returns
    numpy limbs): each chunk is counted and merged into the running table,
    which stays on the device (spilling past the row limit), and the
    coverage band applies once at the end."""
    return _stream(chunks, [k], min_cov=min_cov, max_cov=max_cov,
                   front_clip=front_clip, end_clip=end_clip, device=device,
                   plain=plain)[k]


def _file_chunks(pattern: str, params, budget_bytes: int, klist):
    """:func:`io.iter_read_chunks`, with chunks wider than a counting pass
    (``STREAM_WINDOW_LIMIT // W`` windows at the largest W and the
    smallest k) cut into row slices; chunks narrower than the smallest k
    hold no window and are dropped."""
    from .io import iter_read_chunks

    kmin = min(klist)
    limit = STREAM_WINDOW_LIMIT // max(num_words(k) for k in klist)
    for m, lens in iter_read_chunks(pattern, params,
                                    budget_bytes=budget_bytes):
        if m.shape[1] < kmin:
            continue
        rows = max(1, limit // (m.shape[1] - kmin + 1))
        for lo in range(0, m.shape[0], rows):
            yield m[lo:lo + rows], lens[lo:lo + rows]


def count_kmers_from_files_multi(
    pattern: str, klist, *, min_cov: int, max_cov: int = 10_000_000,
    front_clip: int = 0, end_clip: int = 0, params=None,
    budget_bytes: int = 1 << 30, device, plain: bool = False,
) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Out-of-core counting of several k in one pass over the input
    (``count.count_kmers_from_files_multi``): chunks of about
    ``budget_bytes`` of input stream from disk (``params`` applies the
    ``-minlength``/``-reads`` filters), each goes to the device once and is
    counted for every k. Host memory holds about two chunks (the prefetch
    queue) and whatever tables spill; the read matrix is never built.
    Returns ``{k: (keys, counts)}`` on ``device``."""
    klist = sorted(set(klist))
    chunks = _maybe_prefetch(_file_chunks(pattern, params, budget_bytes,
                                          klist))
    return _stream(chunks, klist,
                   min_cov=min_cov, max_cov=max_cov, front_clip=front_clip,
                   end_clip=end_clip, device=device, plain=plain)


def count_kmers_from_files(
    pattern: str, *, k: int, min_cov: int, max_cov: int = 10_000_000,
    front_clip: int = 0, end_clip: int = 0, params=None,
    budget_bytes: int = 1 << 30, device, plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`count_kmers_from_files_multi` for one k
    (``count.count_kmers_from_files``)."""
    return count_kmers_from_files_multi(
        pattern, [k], min_cov=min_cov, max_cov=max_cov,
        front_clip=front_clip, end_clip=end_clip, params=params,
        budget_bytes=budget_bytes, device=device, plain=plain)[k]
