"""Stitching: contigs joined across thin gaps by read k-mers
(``reflexiv_tpu.stitch``; the ``stitch`` command, ``Pipelines.java:208-309``
and ``ReflexivDSStitching``).

For each k of the ladder 21, 31, 61 below the longest read less 2, the
contigs re-enter the single-k extension loop as free-ended records beside
the fork-filtered k-mer records of the reads, with the k-mer records inside
a contig removed; the deduplicated contigs feed the next k
(``Assembly_stitched_<k>/``). The k-mer records come from
``Stitch_kmer/Count_<k>_sorted`` when an earlier ``reduce`` left it, else
from counting every read k-mer up to ``-maxcov``: as in the JAX package,
which admits more than the reference's coverage-1 k-mers
(``Pipelines.java:247-248``), since overlapping single-copy reads make
bridge k-mers of coverage 2 and more.

The loop runs on the chain pool (:mod:`reflexiv_tpu_torch.chains`): its
rows are the packed pool's row for row, but its memory does not grow with
the contigs' length, so whole genomes' contigs stitch beside tens of
millions of k-mer records.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Tuple

import numpy as np
import torch

from . import chains, metrics
from .assembler import initial_records_from_counts
from .count import _as_device, count_kmers_auto
from .device import resolve_device, synchronize
from .params import Params
from .reassemble import remove_fragment_kmers
from .records import Records, compact, next_pow2

log = logging.getLogger("reflexiv_tpu_torch")

STITCH_KLIST = (21, 31, 61)  # Pipelines.java:208-309 ladder


def _stitch_records_from_table(params: Params, k: int, device):
    """The fork-filtered records of ``Stitch_kmer/Count_<k>_sorted`` from
    an earlier ``reduce`` (both strands with their attrs), compacted as the
    counted path's are (counter ``stitch/table_rows_k<k>``); None when the
    table is absent."""
    from .dynamic import read_sorted_set
    from .io import has_success_marker

    if not params.output_path:
        return None
    sdir = os.path.join(params.output_path, "Stitch_kmer",
                        f"Count_{k}_sorted")
    if not has_success_marker(sdir):
        return None
    b, left, right = read_sorted_set(sdir, k)
    log.info("stitch k=%d: reusing %s (%d rows)", k, sdir, len(b))
    metrics.current().set(f"stitch/table_rows_k{k}", len(b))
    n = len(b)
    recs = Records(
        torch.from_numpy(np.ascontiguousarray(b, np.uint8)).to(device),
        torch.full((n,), k, dtype=torch.int32, device=device),
        torch.from_numpy(left.astype(np.int32)).to(device),
        torch.from_numpy(right.astype(np.int32)).to(device),
        torch.ones(n, dtype=torch.bool, device=device))
    return compact(recs, max(next_pow2(n), 16))


def stitch_contigs(bases, lengths, contigs: List[str], params: Params, *,
                   klist: Tuple[int, ...] = STITCH_KLIST, seed: int = 0,
                   device, plain: bool = False) -> List[str]:
    """One stitching ladder over ``contigs`` (``stitch.stitch_contigs``):
    rung i runs with min_cov 1 and seed ``seed + 7919 * i``, and writes
    ``Assembly_stitched_<k>/`` under ``-outfile`` when one is set.
    ``plain=True`` counts and cuts windows through the kernels' plain
    torch versions. Counters ``stitch/records_k<k>`` (records entering the
    loop), ``stitch/extension_rounds_k<k>``, ``stitch/contigs_k<k>`` and,
    on a card, ``stitch/peak_bytes_k<k>`` (the most device memory
    allocated since the caller last reset the peak); laps
    ``stitch/k<k>``."""
    from .io import write_contigs_fasta, write_success_marker
    from .meta import dedup_contigs

    device = resolve_device(device)
    met = metrics.current()
    current = contigs
    max_read = int(lengths.max()) if len(lengths) else 0
    bases = _as_device(bases, torch.uint8, device)
    lengths = _as_device(lengths, torch.int32, device)
    for i, k in enumerate(k for k in klist if k + 2 < max_read):
        met.lap_start()
        p = dataclasses.replace(params, k=k, min_kmer_coverage=1)
        recs = _stitch_records_from_table(params, k, device)
        if recs is None:
            keys, counts = count_kmers_auto(
                bases, lengths, k=k, min_cov=1,
                max_cov=params.max_kmer_coverage, device=device, plain=plain)
            recs, _n_live = initial_records_from_counts(keys, counts, p)
            del keys, counts
        recs = remove_fragment_kmers(recs, current, k, plain=plain)
        pool, pieces = chains.from_records(recs, current, k)
        del recs
        met.set(f"stitch/records_k{k}", int(pool.live.sum()))
        groups = chains.run_extension_loop(pool, pieces, p,
                                           seed=seed + 7919 * i)
        emitted = chains.emit_contigs(groups, pieces, k=k,
                                      min_contig=params.min_contig)
        del groups, pieces, pool
        current = dedup_contigs([s for _, s in emitted])
        met.set(f"stitch/contigs_k{k}", len(current))
        log.info("stitch k=%d: %d contigs", k, len(current))
        if params.output_path:
            kdir = os.path.join(params.output_path, f"Assembly_stitched_{k}")
            write_contigs_fasta(
                os.path.join(kdir, "part-00000"),
                [(f">Contig-{len(s)}-{j}", s) for j, s in enumerate(current)],
                gzip_output=params.gzip_output)
            write_success_marker(kdir)
        synchronize(device)
        met.lap(f"stitch/k{k}")
        if device.type == "cuda":
            met.set(f"stitch/peak_bytes_k{k}",
                    torch.cuda.max_memory_allocated(device))
    return current


def stitch(params: Params, *, seed: int = 0, device,
           plain: bool = False) -> None:
    """The ``stitch`` command: ``-fastq`` reads and ``-frag`` contigs; the
    last rung's contigs also go to ``Assembly_stitched_61/``."""
    from .io import (expand_paths, iter_fasta, load_reads_filtered,
                     write_contigs_fasta, write_success_marker)

    if not params.input_contig:
        raise SystemExit("error: stitch requires -frag contig input")
    contigs = [s.decode() for _, s in
               iter_fasta(expand_paths(params.input_contig))]
    mat, lens = load_reads_filtered(
        params.input_fastq or params.input_fasta, params)
    stitched = stitch_contigs(mat, lens, contigs, params, seed=seed,
                              device=device, plain=plain)
    out_dir = os.path.join(params.output_path,
                           f"Assembly_stitched_{STITCH_KLIST[-1]}")
    write_contigs_fasta(os.path.join(out_dir, "part-00000"),
                        [(f">Contig-{len(s)}-{i}", s)
                         for i, s in enumerate(stitched)],
                        gzip_output=params.gzip_output)
    write_success_marker(out_dir)
    log.info("stitch: %d -> %d contigs", len(contigs), len(stitched))
