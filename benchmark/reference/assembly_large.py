"""Plain PyTorch reference of Reflexiv's single-k ``run`` flow for genomes
whose windows do not fit on the card at once: :mod:`reference.assembly`
with the count partitioned.

The one departure from :mod:`reference.assembly` is how the count is
computed, not what it gives. There every window's canonical key is
concatenated and made unique at once; at 100 Mbp and 30x that is 2.41G
keys (19.3 GB), which ``torch.unique`` cannot sort on one card. Here the
reads go through once, in blocks of ``block_windows`` windows that are
uploaded one at a time. Each block's distinct canonical keys, with their
counts in the block, are routed by their leading bits into one of
``partitions`` key ranges and kept in host memory. Each range is then
counted whole on the device (the sum of its blocks' counts per key). The
ranges follow the keys' order, so their tables laid end to end, with the
coverage band applied, are the one table ``reference.assembly.count``
gives, row for row; so is its control (``fingerprint_bits``). No step
holds every window's key.

The graph, the extension rounds, the stop rules and the contigs are
:mod:`reference.assembly`'s own, imported, not copied.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .assembly import (WORD_BASES, Extension, Graph, canonical_windows,
                       fingerprint, unique_rows)

BLOCK_WINDOWS = 1 << 28   # windows a block: about 12 GB of transients
PARTITIONS = 16           # key ranges counted one at a time
ROUTE_BITS = 16           # leading bits of a key that pick its range


def key_range(words: torch.Tensor, k: int, partitions: int) -> torch.Tensor:
    """The range of each ``(N, W)`` key row, from the leading
    :data:`ROUTE_BITS` bits of its first word (which holds the first
    ``min(k, 31)`` bases, first base highest): non-decreasing in the
    key's order, so ranges in order hold the keys in order."""
    bits = 2 * min(k, WORD_BASES)
    shift = max(bits - ROUTE_BITS, 0)
    return ((words[:, 0] >> shift) * partitions) >> (bits - shift)


def count(codes, k: int, *, cover: int, maxcov: int,
          partitions: int = PARTITIONS, block_windows: int = BLOCK_WINDOWS,
          device="cpu", fingerprint_bits: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solid canonical k-mers of ``(R, L)`` read codes (numpy, held on the
    host) and their counts, ``((U, W) words, (U,) int64)`` on ``device``:
    ``reference.assembly.count``'s table, counted in ``partitions`` key
    ranges from blocks of ``block_windows`` windows. ``fingerprint_bits``
    counts a hash of the k-mer, as there (the control)."""
    codes = np.asarray(codes)
    R, L = codes.shape
    rows = max(1, block_windows // (L - k + 1))
    parts = [[] for _ in range(partitions)]
    for lo in range(0, R, rows):
        block = torch.as_tensor(codes[lo:lo + rows]).to(device)
        keys, _inv, n = unique_rows(canonical_windows(block, k))
        del block, _inv
        dest = key_range(keys, k, partitions)
        for p in range(partitions):
            at = dest == p
            parts[p].append((keys[at].cpu(), n[at].cpu()))
        del keys, n, dest
    kmers, counts = [], []
    for p in range(partitions):
        keys = torch.cat([a for a, _b in parts[p]]).to(device)
        n = torch.cat([b for _a, b in parts[p]]).to(device)
        parts[p] = None
        u, inv, _c = unique_rows(keys)
        del keys
        counts.append(torch.zeros(u.shape[0], dtype=torch.int64,
                                  device=device).scatter_add_(0, inv, n))
        kmers.append(u)
        del u, inv, n
    kmers, counts = torch.cat(kmers), torch.cat(counts)
    if fingerprint_bits is not None:
        fp = fingerprint(kmers, fingerprint_bits)
        _u, fp_id, _c = unique_rows(fp[:, None])
        total = torch.zeros(int(fp_id.max()) + 1, dtype=torch.int64,
                            device=fp.device).scatter_add_(0, fp_id, counts)
        counts = total[fp_id]
    keep = (counts >= cover) & (counts <= maxcov)
    return kmers[keep], counts[keep]


def assemble(codes, *, k: int, cover: int, maxcov: int, error: int,
             mincontig: int, maxiter: int, miniter: int, seed: int,
             device, partitions: int = PARTITIONS,
             block_windows: int = BLOCK_WINDOWS,
             fingerprint_bits: Optional[int] = None) -> dict:
    """``reference.assembly.assemble`` over the partitioned count: the
    contigs of ``(R, L)`` read codes (numpy, kept on the host) with the
    counts along the way."""
    kmers, counts = count(codes, k, cover=cover, maxcov=maxcov,
                          partitions=partitions, block_windows=block_windows,
                          device=device, fingerprint_bits=fingerprint_bits)
    g = Graph(kmers, counts, k=k, error=error)
    del kmers, counts
    ext = Extension(g)
    rounds = ext.run(seed=seed, maxiter=maxiter, miniter=miniter)
    contigs = ext.contigs(mincontig)
    return {"contigs": contigs, "solid_kmers": g.bases.shape[0] // 2,
            "records": int(g.records.numel()), "rounds": rounds}
