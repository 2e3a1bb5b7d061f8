"""Contig emission, canonicalization and the assembly report (``reflexiv_tpu.contigs``).

Mirrors ``DSKmerToContig`` + ``TagRowContigID`` (``ReflexivDSMain.java:715-795``):
a live record's sequence is a contig if it is at least ``minContig`` long
and not repeat-killed (both attrs <= -10000000, ``ReflexivDSMain.java:749``).
IDs are ``>Contig-<len>-(<left>,<right>)-<idx>``.
"""
from __future__ import annotations

import operator
import os
from typing import Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import metrics
from .io import FASTA_LINE
from .packed import BASES_PER_LIMB, PackedRecords
from .records import REPEAT_KILLED

EMIT_BASES = 1 << 26   # contig bases spelled at once when emitting


def spell_rows(seq: torch.Tensor, rows: torch.Tensor, lengths: List[int]
               ) -> Tuple[torch.Tensor, ...]:
    """Spell rows ``rows`` of the packed ``(N, LW)`` limbs ``seq``, of
    ``lengths`` bases each (none empty, fewer than 2^31 in all), on
    ``seq``'s device, back to back in row order: the ASCII text, the FASTA
    bodies (a newline after every ``FASTA_LINE``-th base and after the
    last), the RC-canonical text and each row's G+C count (codes 1 and 2).

    The codes order A < C < G < T as the letters do, so a row's canonical
    strand (:func:`canonical_contig`) is its reverse complement exactly
    where its first code that differs from the reverse complement's is
    the larger; a palindrome keeps its strand."""
    dev = seq.device
    bases = sum(lengths)
    L = torch.tensor(lengths, dtype=torch.int32, device=dev)
    end = torch.cumsum(L, 0, dtype=torch.int32)
    start = end - L
    ids = torch.arange(len(lengths), dtype=torch.int32, device=dev)

    def before(count: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
        """The running ``count`` before each position ``at``."""
        return torch.where(at > 0, count[(at - 1).clamp(min=0)], 0)

    # the rows' limbs back to back, then each base from its limb
    nl = (L + BASES_PER_LIMB - 1) // BASES_PER_LIMB
    lstart = torch.cumsum(nl, 0, dtype=torch.int32) - nl
    n_limbs = sum(-(-n // BASES_PER_LIMB) for n in lengths)
    lrow = torch.repeat_interleave(ids, nl, output_size=n_limbs)
    lcol = torch.arange(n_limbs, dtype=torch.int32, device=dev) - lstart[lrow]
    limbs = seq[rows[lrow], lcol.long()]
    del lrow, lcol
    row = torch.repeat_interleave(ids, L, output_size=bases)
    pos = torch.arange(bases, dtype=torch.int32, device=dev)
    col = pos - start[row]
    code = limbs[lstart[row] + col // BASES_PER_LIMB]
    code >>= 30 - 2 * (col % BASES_PER_LIMB)
    fwd = (code & 3).to(torch.uint8)
    del code, limbs
    # the reverse complement, position for position
    rc = 3 - fwd[(start + end - 1)[row] - pos]
    differ = torch.cumsum(fwd != rc, 0, dtype=torch.int32)
    first = torch.searchsorted(differ, before(differ, start) + 1,
                               out_int32=True)
    at = first.clamp(max=bases - 1)
    reverse = (first < end) & (fwd[at] > rc[at])
    del differ
    canon = torch.where(reverse[row], rc, fwd)
    del rc
    strong = torch.cumsum((fwd == 1) | (fwd == 2), 0, dtype=torch.int32)
    gc = strong[end - 1] - before(strong, start)
    del strong
    ascii_ = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    text = ascii_[fwd.int()]
    canon = ascii_[canon.int()]
    lines = (L + FASTA_LINE - 1) // FASTA_LINE
    n_lines = sum(-(-n // FASTA_LINE) for n in lengths)
    fasta = torch.full((bases + n_lines,), ord("\n"), dtype=torch.uint8,
                       device=dev)
    fasta[pos + (torch.cumsum(lines, 0, dtype=torch.int32) - lines)[row]
          + col // FASTA_LINE] = text
    return text, fasta, canon, gc


class Spelled(NamedTuple):
    """One chunk of :func:`emit_contigs`'s contigs as :func:`spell_rows`
    spelled them, on the host."""
    lengths: List[int]
    fasta: np.ndarray      # uint8 FASTA bodies, back to back
    canonical: np.ndarray  # uint8 RC-canonical text, back to back
    gc: List[int]

    def fasta_bodies(self) -> Iterator[memoryview]:
        """Each contig's FASTA body, a view of :attr:`fasta`."""
        view, at = memoryview(self.fasta), 0
        for n in self.lengths:
            end = at + n + -(-n // FASTA_LINE)
            yield view[at:end]
            at = end

    def canonical_texts(self) -> Iterator[str]:
        """Each contig's RC-canonical text."""
        text, at = str(self.canonical, "ascii"), 0
        for n in self.lengths:
            yield text[at:at + n]
            at += n


class EmittedContigs(list):
    """:func:`emit_contigs`'s (id, sequence) pairs, a list like any other,
    with the chunks the device spelled them in. :attr:`spelled` hands
    those out while the list holds the very pairs they were spelled for,
    and None once it was edited; the FASTA writer and the report then go
    by the strings."""

    def __init__(self, pairs: List[Tuple[str, str]], chunks: List[Spelled]):
        super().__init__(pairs)
        self._pairs = tuple(pairs)
        self._chunks = chunks

    @property
    def spelled(self) -> Optional[List[Spelled]]:
        same = len(self) == len(self._pairs) and \
            all(map(operator.is_, self, self._pairs))
        return self._chunks if same else None


def emit_contigs(groups: Iterable[PackedRecords], *,
                 min_contig: int) -> EmittedContigs:
    """(id, sequence) pairs of the emitted rows of packed record groups,
    group after group, each in row order (``contigs.emit_contigs`` over the
    JAX package's merged pool). Rows are selected on the device and
    spelled there (:func:`spell_rows`) in runs of at most
    :data:`EMIT_BASES` bases (a longer row on its own); each run's text
    comes to the host in one copy and is cut into the pairs' sequences.
    Counts ``output/spelled_bases`` and ``output/spelled_chunks``."""
    met = metrics.current()
    pairs: List[Tuple[str, str]] = []
    chunks: List[Spelled] = []
    for g in groups:
        keep = g.live & (g.length >= min_contig) & ~(
            (g.left <= REPEAT_KILLED) & (g.right <= REPEAT_KILLED))
        idx = torch.nonzero(keep).squeeze(1)
        length = g.length[idx].tolist()
        left = g.left[idx].tolist()
        right = g.right[idx].tolist()
        lo = 0
        while lo < len(length):
            hi, bases = lo + 1, length[lo]
            while hi < len(length) and bases + length[hi] <= EMIT_BASES:
                bases += length[hi]
                hi += 1
            lens = length[lo:hi]
            text, fasta, canon, gc = (
                t.cpu() for t in spell_rows(g.seq, idx[lo:hi], lens))
            seqs, at = str(text.numpy(), "ascii"), 0
            for i, n in enumerate(lens, lo):
                pairs.append((f">Contig-{n}-({left[i]},{right[i]})"
                              f"-{len(pairs)}", seqs[at:at + n]))
                at += n
            chunks.append(Spelled(lens, fasta.numpy(), canon.numpy(),
                                  gc.tolist()))
            met.add("output/spelled_bases", bases)
            met.add("output/spelled_chunks")
            lo = hi
    return EmittedContigs(pairs, chunks)


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


def _canonical_sorted(contigs: List[Tuple[str, str]]
                      ) -> Tuple[List[str], Optional[List[int]]]:
    """The RC-canonical contig set, longest first and equal lengths in the
    set's own order, with each member's G+C count where the device
    spelled the contigs (:class:`EmittedContigs`), else None."""
    spelled = getattr(contigs, "spelled", None)
    if spelled is None:
        return sorted(canonical_set(contigs), key=len, reverse=True), None
    canon = [s for chunk in spelled for s in chunk.canonical_texts()]
    gc = [g for chunk in spelled for g in chunk.gc]
    # the set as canonical_set builds it: the same strings, in the same order
    seqs = sorted(set(canon), key=len, reverse=True)
    gc_of = dict(zip(canon, gc))
    return seqs, [gc_of[s] for s in seqs]


def _summary(lengths: List[int], gc: int) -> dict:
    """Counts, N50/L50 and GC of the canonical set, longest first."""
    total = sum(lengths)
    acc, n50, l50 = 0, 0, 0
    for i, n in enumerate(lengths):
        acc += n
        if acc * 2 >= total and not n50:
            n50, l50 = n, i + 1
    return {
        "n_contigs": len(lengths),
        "total_bp": total,
        "longest": lengths[0] if lengths else 0,
        "n50": n50,
        "l50": l50,
        "gc_pct": round(100.0 * gc / total, 2) if total else 0.0,
    }


def write_assembly_report(path: str, contigs: List[Tuple[str, str]]) -> dict:
    """QUAST-style plain-text report over the canonicalized contig set:
    summary block (counts, N50/L50, GC, length bands) + per-contig table.
    Returns the summary dict."""
    seqs, gc = _canonical_sorted(contigs)
    if gc is None:
        gc = [s.count("G") + s.count("C") for s in seqs]
    lengths = [len(s) for s in seqs]
    summary = _summary(lengths, sum(gc))
    bands = [(0, 1000), (1000, 10_000), (10_000, 100_000),
             (100_000, 1 << 62)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("# Assembly report (canonicalized contigs)\n")
        for key, val in summary.items():
            fh.write(f"{key}\t{val}\n")
        for lo, hi in bands:
            band = [n for n in lengths if lo <= n < hi]
            label = f">={lo}" if hi > 1 << 61 else f"{lo}-{hi}"
            fh.write(f"contigs[{label}]\t{len(band)}\t{sum(band)}\n")
        fh.write("# per-contig: idx\tlength\tgc_pct\n")
        fh.writelines(f"{i}\t{n}\t{round(100.0 * g / n, 2)}\n"
                      for i, (n, g) in enumerate(zip(lengths, gc)))
    return summary


def assembly_stats(contigs: List[Tuple[str, str]]) -> dict:
    """Assembly metrics over the RC-canonicalized, deduplicated contig set
    (the FASTA holds one contig per strand, as the reference's does)."""
    seqs, _gc = _canonical_sorted(contigs)
    summary = _summary([len(s) for s in seqs], 0)
    return {key: summary[key]
            for key in ("n_contigs", "total_bp", "longest", "n50")}
