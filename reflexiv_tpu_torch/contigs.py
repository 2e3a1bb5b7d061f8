"""Contig emission, canonicalization and the assembly report (``reflexiv_tpu.contigs``).

Mirrors ``DSKmerToContig`` + ``TagRowContigID`` (``ReflexivDSMain.java:715-795``):
a live record's sequence is a contig if it is at least ``minContig`` long
and not repeat-killed (both attrs <= -10000000, ``ReflexivDSMain.java:749``).
IDs are ``>Contig-<len>-(<left>,<right>)-<idx>``.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import torch

from .bitpack import decode_to_str
from .records import REPEAT_KILLED, Records


def emit_contigs(recs: Records, *, min_contig: int) -> List[Tuple[str, str]]:
    """(id, sequence) pairs of the emitted records, in row order. Rows are
    selected on the device, so only emitted sequences reach the host."""
    keep = recs.live & (recs.length >= min_contig) & ~(
        (recs.left <= REPEAT_KILLED) & (recs.right <= REPEAT_KILLED))
    idx = torch.nonzero(keep).squeeze(1)
    seq = recs.seq[idx].cpu().numpy()
    length = recs.length[idx].tolist()
    left = recs.left[idx].tolist()
    right = recs.right[idx].tolist()
    return [
        (f">Contig-{n}-({lf},{rt})-{i}", decode_to_str(seq[i, :n]))
        for i, (n, lf, rt) in enumerate(zip(length, left, right))
    ]


def revcomp_str(s: str) -> str:
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    return s.translate(comp)[::-1]


def canonical_contig(s: str) -> str:
    """RC-canonical form: min(seq, revcomp(seq)). Output orientation is
    scan-order dependent in the reference, so contig-set equality is defined
    over this form."""
    rc = revcomp_str(s)
    return s if s <= rc else rc


def canonical_set(contigs: List[Tuple[str, str]]) -> set:
    return {canonical_contig(seq) for _, seq in contigs}


def write_assembly_report(path: str, contigs: List[Tuple[str, str]]) -> dict:
    """QUAST-style plain-text report over the canonicalized contig set:
    summary block (counts, N50/L50, GC, length bands) + per-contig table.
    Returns the summary dict."""
    seqs = sorted(canonical_set(contigs), key=len, reverse=True)
    total = sum(len(s) for s in seqs)
    gc = sum(s.count("G") + s.count("C") for s in seqs)
    acc, n50, l50 = 0, 0, 0
    for i, s in enumerate(seqs):
        acc += len(s)
        if acc * 2 >= total and not n50:
            n50, l50 = len(s), i + 1
    bands = [(0, 1000), (1000, 10_000), (10_000, 100_000),
             (100_000, 1 << 62)]
    summary = {
        "n_contigs": len(seqs),
        "total_bp": total,
        "longest": len(seqs[0]) if seqs else 0,
        "n50": n50,
        "l50": l50,
        "gc_pct": round(100.0 * gc / total, 2) if total else 0.0,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("# Assembly report (canonicalized contigs)\n")
        for key, val in summary.items():
            fh.write(f"{key}\t{val}\n")
        for lo, hi in bands:
            n = sum(1 for s in seqs if lo <= len(s) < hi)
            bp = sum(len(s) for s in seqs if lo <= len(s) < hi)
            label = f">={lo}" if hi > 1 << 61 else f"{lo}-{hi}"
            fh.write(f"contigs[{label}]\t{n}\t{bp}\n")
        fh.write("# per-contig: idx\tlength\tgc_pct\n")
        for i, s in enumerate(seqs):
            g = s.count("G") + s.count("C")
            fh.write(f"{i}\t{len(s)}\t{round(100.0 * g / len(s), 2)}\n")
    return summary


def assembly_stats(contigs: List[Tuple[str, str]]) -> dict:
    """Assembly metrics over the RC-canonicalized, deduplicated contig set
    (the FASTA holds one contig per strand, as the reference's does)."""
    seqs = sorted(canonical_set(contigs), key=len, reverse=True)
    if not seqs:
        return {"n_contigs": 0, "total_bp": 0, "longest": 0, "n50": 0}
    total = sum(len(s) for s in seqs)
    acc, n50 = 0, 0
    for s in seqs:
        acc += len(s)
        if acc * 2 >= total:
            n50 = len(s)
            break
    return {
        "n_contigs": len(seqs),
        "total_bp": total,
        "longest": len(seqs[0]),
        "n50": n50,
    }
