"""Mercy k-mers: sub-threshold k-mers rescued between solid flanks
(``reflexiv_tpu.mercy``).

``ReflexivDSDynamicMercyKmer`` (``:157-321``): a k-mer below the coverage
threshold is re-admitted when it sits inside a read between two solid
k-mers, so low-coverage stretches inside well-covered loci still assemble.
``-accurate`` adds the rescued k-mers to each k's table in ``reduce`` and
``meta`` (``Pipelines.java:1388-1391``); the ``mercy`` command assembles
one k from the solid + mercy table.

On the device: the min_cov = 1 table is counted through the extraction
and radix-sort kernels; each read window's canonical key is cut again by
the extraction kernel and looked up in the sorted table
(``torch.searchsorted`` on int64 keys, a lexicographic binary search on
word rows for k >= 32); the flank rule is a ``cumsum`` along each read
row. The JAX package unions queries and table in one sort; both give each
window its table count, or 0 when absent.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Tuple

import torch

from . import metrics
from .bitpack import num_words, searchsorted_rows
from .count import _as_device, count_kmers_auto, extract_windows
from .device import resolve_device, synchronize
from .kernels import extract as extract_mod

log = logging.getLogger("reflexiv_tpu_torch")

# windows one mercy pass takes, table included (``dynamic.STREAM_WINDOW_LIMIT``)
STREAM_WINDOW_LIMIT = 1 << 27


def lookup_counts(table_keys: torch.Tensor, table_counts: torch.Tensor,
                  query_keys: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query count in a sorted unique table (``(U,)`` int64 keys or
    ``(U, W)`` word rows), 0 where absent, and the query's table position
    (meaningful where the count is not 0)."""
    U, N = table_keys.shape[0], query_keys.shape[0]
    if U == 0:
        return (torch.zeros(N, dtype=torch.int32, device=query_keys.device),
                torch.zeros(N, dtype=torch.int64, device=query_keys.device))
    if table_keys.dim() == 1:
        pos = torch.searchsorted(table_keys, query_keys)
    else:
        pos = searchsorted_rows(table_keys, query_keys)
    pos = pos.clamp(max=U - 1)
    eq = table_keys[pos] == query_keys
    if eq.dim() == 2:
        eq = eq.all(dim=1)
    return torch.where(eq, table_counts[pos], 0).to(torch.int32), pos


def window_counts(bases: torch.Tensor, lengths: torch.Tensor,
                  table_keys: torch.Tensor, table_counts: torch.Tensor, *,
                  k: int, plain: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every read window's canonical key, cut by the extraction kernel (its
    plain version with ``plain``), looked up in the table: returns
    ``(counts, table positions, valid)`` over the ``R * (L-k+1)`` windows.
    An invalid window's key is poly-T, never canonical, so it counts 0."""
    keys, valid = window_keys(bases, lengths, k=k, plain=plain)
    counts, pos = lookup_counts(table_keys, table_counts, keys)
    return counts, pos, valid


def window_keys(bases: torch.Tensor, lengths: torch.Tensor, *, k: int,
                plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every read window's canonical key, cut by the extraction kernel (its
    plain version with ``plain``), and whether the window is valid (its
    key is not the poly-T sentinel)."""
    keys = extract_windows(bases, lengths, k=k, plain=plain)
    sent = torch.tensor(extract_mod.sentinel(k), dtype=torch.int64,
                        device=keys.device)
    valid = keys != sent if num_words(k) == 1 else (keys != sent).any(dim=1)
    return keys, valid


def _mercy_mask(bases, lengths, table_keys, table_counts, *, k: int,
                min_cov: int, plain: bool = False):
    """``(table positions, mercy)`` over the block's windows: a weak window
    (count in [1, min_cov)) with a solid window strictly left and strictly
    right of it in its read (``mercy._mercy_mask``)."""
    counts, pos, valid = window_counts(bases, lengths, table_keys,
                                       table_counts, k=k, plain=plain)
    return pos, flank_rule(counts, valid, bases.shape[0], min_cov)


def flank_rule(counts: torch.Tensor, valid: torch.Tensor, R: int,
               min_cov: int) -> torch.Tensor:
    """Mercy windows among the ``R`` reads' windows (row-major), from each
    window's table count: weak, with a solid window strictly left and
    strictly right of it in its read, by a ``cumsum`` along the row."""
    if R == 0:
        return valid.clone()
    solid = ((counts >= min_cov) & valid).view(R, -1)
    weak = ((counts >= 1) & (counts < min_cov) & valid).view(R, -1)
    s32 = solid.to(torch.int32)
    csum = torch.cumsum(s32, dim=1)
    solid_left = csum > 0
    solid_right = (csum[:, -1:] - csum + s32) > 0
    mercy = weak & solid_left & solid_right & ~solid
    return mercy.reshape(-1)


def mercy_kmer_table(bases, lengths, *, k: int, min_cov: int,
                     max_cov: int = 10_000_000, block_rows: int = 0, device,
                     plain: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solid + mercy k-mer table for ``-accurate`` (``mercy
    .mercy_kmer_table``): the min_cov = 1 table of the reads (no clips, as
    the JAX package counts it; streamed past one pass's windows,
    :func:`count.count_kmers_auto`), restricted to the k-mers of at least
    ``min_cov`` and those a mercy window holds. Keys ascending, as
    :func:`count.count_kmers` returns them, on ``device``. The windows go
    through in read-row blocks so table + block stay under
    :data:`STREAM_WINDOW_LIMIT` windows (``block_rows`` forces a size; the
    table is the same). Sets the counter ``mercy/rescued_k<k>``."""
    device = resolve_device(device)
    b = _as_device(bases, torch.uint8, device)
    lens = _as_device(lengths, torch.int32, device)
    keys, counts = count_kmers_auto(b, lens, k=k, min_cov=1,
                                    max_cov=max_cov, device=device,
                                    plain=plain)
    solid = counts >= min_cov
    R, L = b.shape
    Wn = max(L - k + 1, 0)
    budget = max(STREAM_WINDOW_LIMIT - counts.numel(), 1 << 20)
    rows = block_rows or max(1, min(R, budget // max(Wn, 1)))
    keep = solid.clone()
    for lo in range(0, R, rows):
        pos, mercy = _mercy_mask(b[lo:lo + rows], lens[lo:lo + rows], keys,
                                 counts, k=k, min_cov=min_cov, plain=plain)
        keep[pos[mercy]] = True
    n_solid = int(solid.sum())
    n_mercy = int(keep.sum()) - n_solid
    log.info("mercy k=%d: %d solid + %d mercy k-mers", k, n_solid, n_mercy)
    metrics.current().set(f"mercy/rescued_k{k}", n_mercy)
    return keys[keep], counts[keep]


def mercy_assembly(params, *, seed: int = 0, device,
                   plain: bool = False) -> None:
    """The ``mercy`` command (``MainOfMercy`` ->
    ``ReflexivDSMainMercy.assembly``; ``mercy.mercy_assembly``): single-k
    assembly over the solid + mercy table; writes ``part-00000`` and
    ``_SUCCESS``, no report. ``plain=True`` builds the table through the
    kernels' plain torch versions."""
    from .assembler import assemble_from_counts
    from .io import (load_reads_filtered, write_contigs_fasta,
                     write_success_marker)

    device = resolve_device(device)
    met = metrics.current()
    t0 = time.perf_counter()
    mat, lens = load_reads_filtered(
        params.input_fastq or params.input_fasta, params)
    met.add_time("mercy/ingest", time.perf_counter() - t0)
    t0 = time.perf_counter()
    keys, counts = mercy_kmer_table(
        mat, lens, k=params.k, min_cov=params.min_kmer_coverage,
        max_cov=params.max_kmer_coverage, device=device, plain=plain)
    synchronize(device)
    met.add_time("mercy/table", time.perf_counter() - t0)
    met.lap_start()
    contigs = assemble_from_counts(keys, counts, params, seed=seed,
                                   device=device)
    out = params.output_path
    write_contigs_fasta(os.path.join(out, "part-00000"), contigs,
                        gzip_output=params.gzip_output)
    write_success_marker(out)
    log.info("mercy: %d contigs -> %s", len(contigs), out)
