"""Read-graph reassembly of contig fragments (``reflexiv_tpu.reassemble``),
the first half of ``meta``'s stage 04.

Fragments enter as long records (both strands, free ends) beside the
fork-filtered read k-mer records (the legacy ``ReflexivReAssembler``
design, ``ReflexivReAssembler.java:99-292``); the single-k extension loop
then grows them through read-graph paths, and containment dedup drops the
duplicates. K-mer records interior to a fragment are removed first: the
fragment record replaces its own k-mer chain.
"""
from __future__ import annotations

import logging
import os
from typing import List, Tuple

import numpy as np
import torch

from . import metrics
from .assembler import initial_records_from_counts, run_extension_loop
from .bitpack import canonical_rows, num_words, pack_bases, revcomp_bases
from .contigs import emit_contigs, revcomp_str
from .count import count_kmers_auto, extract_windows
from .io import contigs_to_segment_matrix, reads_to_matrix
from .mercy import lookup_counts
from .params import Params
from .records import Records, next_pow2

log = logging.getLogger("reflexiv_tpu_torch")


def _fragment_keys(fragments: List[str], k: int, device,
                   plain: bool = False) -> torch.Tensor:
    """Canonical keys of every k-base window inside a fragment: ``(M,)``
    int64 for k <= 31, ``(M, W)`` word rows above. The windows of the
    segment matrix go through the extraction kernel (``plain``: its plain
    torch version); invalid windows give its sentinel, which no record key
    equals. A fragment of k or k + 1 bases is below the kernel's read
    filter (it takes reads of at least k + 2 bases), so its one or two
    windows are packed here."""
    one = num_words(k) == 1
    keys = []
    mat, lens = contigs_to_segment_matrix(fragments, k=k)
    if len(lens):
        keys.append(extract_windows(torch.from_numpy(mat).to(device),
                                    torch.from_numpy(lens).to(device), k=k,
                                    plain=plain))
    short = [f.encode() for f in fragments if k <= len(f) < k + 2]
    if short:
        smat, slens = reads_to_matrix(short)
        win = torch.from_numpy(np.stack(
            [smat[i, j:j + k] for i in range(len(short))
             for j in range(int(slens[i]) - k + 1)])).to(device)
        fwd = pack_bases(win, k)
        rc = pack_bases(revcomp_bases(win), k)
        keys.append(torch.minimum(fwd, rc) if one else canonical_rows(fwd, rc))
    if not keys:
        return torch.zeros((0,) if one else (0, num_words(k)),
                           dtype=torch.int64, device=device)
    return torch.cat(keys)


def remove_fragment_kmers(recs: Records, fragments: List[str], k: int, *,
                          plain: bool = False) -> Records:
    """Kill the k-mer records whose canonical k-mer lies inside a fragment
    (``reassemble.remove_fragment_kmers``), as set membership of int64
    keys, or above k = 31 of word rows (a search of the sorted unique
    fragment rows). K-mers spanning a fragment boundary hold a base outside
    it and stay."""
    interior = _fragment_keys(fragments, k, recs.seq.device, plain)
    if not interior.shape[0]:
        return recs
    fwd = pack_bases(recs.seq[:, :k], k)
    rc = pack_bases(revcomp_bases(recs.seq[:, :k]), k)
    if interior.dim() == 1:
        hit = torch.isin(torch.minimum(fwd, rc), interior)
    else:
        table = torch.unique(interior, dim=0)
        ones = torch.ones(table.shape[0], dtype=torch.int32,
                          device=table.device)
        hit = lookup_counts(table, ones, canonical_rows(fwd, rc))[0] > 0
    return recs._replace(live=recs.live & ~((recs.length == k) & hit))


def inject_fragments(recs: Records, fragments: List[str], k: int) -> Records:
    """The live records, then every fragment of at least k bases on both
    strands as free-ended records, in a fresh pool
    (``reassemble.inject_fragments``)."""
    both = []
    for f in fragments:
        if len(f) >= k:
            both += [f, revcomp_str(f)]
    if not both:
        return recs
    dev = recs.seq.device
    idx = torch.nonzero(recs.live).squeeze(1)
    n_old = idx.numel()
    cap_rows = next_pow2(n_old + len(both))
    cap_len = max(next_pow2(max(len(f) for f in both)), recs.seq_capacity)
    seq = torch.zeros((cap_rows, cap_len), dtype=torch.uint8, device=dev)
    seq[:n_old, :recs.seq_capacity] = recs.seq[idx]
    fmat, flens = reads_to_matrix([f.encode() for f in both])
    seq[n_old:n_old + len(both), :fmat.shape[1]] = \
        torch.from_numpy(fmat).to(dev)
    length = torch.zeros(cap_rows, dtype=torch.int32, device=dev)
    length[:n_old] = recs.length[idx]
    length[n_old:n_old + len(both)] = torch.from_numpy(flens).to(dev)
    left = torch.zeros_like(length)
    right = torch.zeros_like(length)
    left[:n_old], right[:n_old] = recs.left[idx], recs.right[idx]
    left[n_old:n_old + len(both)] = -1
    right[n_old:n_old + len(both)] = -1
    live = torch.zeros(cap_rows, dtype=torch.bool, device=dev)
    live[:n_old + len(both)] = True
    return Records(seq, length, left, right, live)


def parse_contig_attrs(header: str) -> Tuple[int, int]:
    """(left, right) of a ``>Contig-<len>-(<left>,<right>)-<idx>`` header;
    (0, 0) when absent."""
    lo, hi = header.find("("), header.find(")")
    if lo < 0 or hi < lo:
        return (0, 0)
    l, _, r = header[lo + 1:hi].partition(",")
    try:
        return (int(l), int(r))
    except ValueError:
        return (0, 0)


def reassemble_arrays(bases, lengths, fragments: List[str], params: Params,
                      *, seed: int = 0, device,
                      plain: bool = False) -> List[Tuple[str, str]]:
    """Reads + fragments -> extended contigs (``reassemble
    .reassemble_arrays``). ``REFLEXIV_REASSEMBLE_BYTES`` (default 8 GiB)
    bounds the unioned pool's byte matrix: the longest fragments pass
    through untouched until it fits (counter ``reassemble/passthrough``). ``plain=True`` counts and cuts the
    fragment windows through the kernels' plain torch versions."""
    from .meta import dedup_contigs

    keys, counts = count_kmers_auto(
        bases, lengths, k=params.k, min_cov=params.min_kmer_coverage,
        max_cov=params.max_kmer_coverage, front_clip=params.front_clip,
        end_clip=params.end_clip, device=device, plain=plain)
    recs, n_live = initial_records_from_counts(keys, counts, params)
    log.info("reassembly: %d k-mer records + %d fragments", n_live,
             len(fragments))
    budget = int(os.environ.get("REFLEXIV_REASSEMBLE_BYTES", str(8 << 30)))
    keep = sorted(fragments, key=len)
    passthrough: List[str] = []
    while keep:
        cap_rows = next_pow2(max(n_live + 2 * len(keep), 1))
        cap_len = next_pow2(max(len(keep[-1]), params.k))
        if cap_rows * cap_len <= budget:
            break
        passthrough.append(keep.pop())
    metrics.current().set("reassemble/passthrough", len(passthrough))
    if passthrough:
        log.warning(
            "reassembly pool exceeds REFLEXIV_REASSEMBLE_BYTES=%d; %d/%d"
            " longest fragments (>= %d bp) pass through read-graph"
            " reassembly untouched", budget, len(passthrough),
            len(fragments), min(len(f) for f in passthrough))
    if not keep:
        return [(f">Contig-{len(f)}-(-1,-1)-{i}", f)
                for i, f in enumerate(fragments)]
    recs = remove_fragment_kmers(recs, keep, params.k, plain=plain)
    recs = inject_fragments(recs, keep, params.k)
    contigs = emit_contigs(run_extension_loop(recs, params, seed=seed),
                           min_contig=params.min_contig)
    attrs = {s: parse_contig_attrs(h) for h, s in contigs}
    out = []
    for i, s in enumerate(dedup_contigs([s for _, s in contigs])):
        l, r = attrs.get(s, (0, 0))
        out.append((f">Contig-{len(s)}-({l},{r})-{i}", s))
    base = len(out)
    for j, f in enumerate(passthrough):
        out.append((f">Contig-{len(f)}-(-1,-1)-{base + j}", f))
    return out


def reassemble(params: Params, *, seed: int = 0, device,
               plain: bool = False) -> None:
    """The ``reassembler`` command (``reassemble.reassemble``;
    ``Pipelines.reflexivDSReAssemblerPipe``, ``Pipelines.java:182-206``):
    ``-fastq`` reads and ``-frag`` fragments -> ``Assemble_<k>/part-00000``
    and ``_SUCCESS``."""
    from .io import (expand_paths, iter_fasta, load_reads_filtered,
                     write_contigs_fasta, write_success_marker)

    if not params.input_contig:
        raise SystemExit("error: reassembler requires -frag contig input")
    fragments = [s.decode() for _, s in
                 iter_fasta(expand_paths(params.input_contig))]
    mat, lens = load_reads_filtered(
        params.input_fastq or params.input_fasta, params)
    contigs = reassemble_arrays(mat, lens, fragments, params, seed=seed,
                                device=device, plain=plain)
    out_dir = os.path.join(params.output_path, f"Assemble_{params.k}")
    write_contigs_fasta(os.path.join(out_dir, "part-00000"), contigs,
                        gzip_output=params.gzip_output)
    write_success_marker(out_dir)
    log.info("reassembler: %d contigs -> %s", len(contigs), out_dir)
