"""Patching: read-pair contig connection (``reflexiv_tpu.patching``).

``meta -patch`` / ``-scaffold`` (``ReflexivDSDynamicKmerPatching``
``:152-370``): read pairs whose mates land on the end regions of two
different contigs vote for a connection; supported, unique connections are
joined on an exact end overlap, or, with ``scaffold``, through a run of
``N``. Mate mapping tracks the strand of every seed hit, so a pair votes
only for the junction its fragment implies, and the insert size observed
within contigs (median + MAD) turns each cross-contig pair into a gap
estimate.

The mapping front end has four forms with the same ten output arrays:
  * the native hashed index + both mates in one C++ call (the default);
  * the native sorted index (:func:`_end_index_arrays`) and
    ``rfx_map_pairs``, when the hashed entry is unavailable;
  * the numpy oracle (``REFLEXIV_NATIVE_PATCH=0`` or
    ``REFLEXIV_DEVICE_STAGES=0``);
  * the device form (``REFLEXIV_DEVICE_STAGES=1``,
    :func:`_map_reads_arrays_device`): seed keys, ``torch.searchsorted``
    and the first hit on the caller's device.
Voting, the insert model and the joins are host numpy, as in the JAX
package, with its order-dependent details: first-seen link order, the
upper median of each link's gaps, the unique-partner filter and the
``dead`` set walked in link order.
"""
from __future__ import annotations

import logging
import os
import statistics
import time
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import metrics
from .bitpack import encode_ascii, revcomp_matrix, rolling_window_values
from .contigs import revcomp_str
from .device import resolve_device
from .device_aux import device_stage_default

log = logging.getLogger("reflexiv_tpu_torch")

END_WINDOW = 300     # bases of each contig end indexed for mate mapping
SEED_K = 31
MIN_LINKS = 2        # read pairs required to support a connection
MIN_OVERLAP = 10     # exact end overlap required to execute a join
DEFAULT_INSERT = 2 * END_WINDOW   # prior when no same-contig pairs exist
MIN_GAP_N = 10       # scaffold joins always leave at least this many Ns


def _ascii_matrix(strs: List[str]):
    """Raw ASCII byte matrix + lengths (pad 0) for a list of sequences."""
    n = len(strs)
    lens = np.fromiter((len(x) for x in strs), np.int32, count=n)
    L = int(lens.max()) if n else 0
    mat = np.zeros((n, L), np.uint8)
    for i, x in enumerate(strs):
        mat[i, : lens[i]] = np.frombuffer(x.encode(), np.uint8)
    return mat, lens


_ACGT_BYTE = np.zeros(256, bool)
for _c in b"ACGTacgt":
    _ACGT_BYTE[_c] = True


def _window_acgt_ok(ascii_mat: np.ndarray, k: int) -> np.ndarray:
    """(R, L-k+1) mask: window j of each row holds only ACGT bytes, so N
    windows (scaffold gaps, low-quality reads) never index nor seed; N
    encodes as T and would otherwise hit a T-rich key."""
    R, L = ascii_mat.shape
    W = L - k + 1
    if W <= 0:
        return np.zeros((R, 0), bool)
    bad = ~_ACGT_BYTE[ascii_mat]
    csum = np.zeros((R, L + 1), np.int32)
    np.cumsum(bad, axis=1, out=csum[:, 1:])
    return (csum[:, k:] - csum[:, :-k]) == 0


class _EndIndexArrays:
    """End-window seed index: ``keys`` is the sorted uint64 2-bit value of
    every unambiguous end-window k-mer (both strands), with aligned payload
    arrays (contig, end 0 = head / 1 = tail, k-mer start, strand 0 = the
    contig's own strand)."""

    __slots__ = ("keys", "ci", "end", "pos", "strand")

    def __init__(self, keys, ci, end, pos, strand):
        self.keys, self.ci, self.end = keys, ci, end
        self.pos, self.strand = pos, strand


def _native_patch_on() -> bool:
    return (os.environ.get("REFLEXIV_NATIVE_PATCH", "1") != "0"
            and os.environ.get("REFLEXIV_DEVICE_STAGES") != "0")


def _end_index_arrays(contigs: List[str], k: int = SEED_K,
                      chunk: int = 4096) -> Optional[_EndIndexArrays]:
    """The end-window index (``patching._end_index_arrays``): a key whose
    placements disagree on (contig, end) is dropped; otherwise the first
    placement in scan order (contig ascending, head then tail, position
    ascending, forward then reverse complement) wins. The threaded C++
    ``rfx_end_index`` builds it by default (identical contents); this numpy
    body is the oracle (``REFLEXIV_NATIVE_PATCH=0`` or
    ``REFLEXIV_DEVICE_STAGES=0``)."""
    from . import native

    C = len(contigs)
    if C == 0:
        return None
    if _native_patch_on() and k <= 31:
        out = native.end_index_native(contigs, k=k, end_window=END_WINDOW)
        if out is not None:
            return _EndIndexArrays(*out) if len(out[0]) else None
    w_all = [min(END_WINDOW, len(s)) for s in contigs]
    regions = (
        ([contigs[i][: w_all[i]] for i in range(C)],
         np.zeros(C, np.int64)),
        ([contigs[i][len(contigs[i]) - w_all[i]:] for i in range(C)],
         np.asarray([len(s) - w for s, w in zip(contigs, w_all)], np.int64)),
    )
    Wg = END_WINDOW - k + 1          # per-region seqno stride (j slots)
    parts: List[Tuple[np.ndarray, ...]] = []
    for region, (seqs, bases) in enumerate(regions):
        for lo in range(0, C, chunk):
            amat, lens = _ascii_matrix(seqs[lo: lo + chunk])
            if amat.shape[1] < k:
                continue
            fwd, rc = rolling_window_values(encode_ascii(amat), k)
            W = fwd.shape[1]
            j = np.arange(W, dtype=np.int64)
            valid = j[None, :] < (lens[:, None].astype(np.int64) - k + 1)
            valid &= _window_acgt_ok(amat, k)
            ri, jj = np.nonzero(valid)
            ci = (lo + ri).astype(np.int64)
            pos = bases[lo + ri] + jj
            base_seq = (ci * 2 + region) * np.int64(2 * Wg) + jj * 2
            for strand, keys in ((0, fwd), (1, rc)):
                parts.append((
                    keys[ri, jj], ci, pos,
                    np.full(len(ri), region, np.int8),
                    np.full(len(ri), strand, np.int8),
                    base_seq + strand,
                ))
    if not parts:
        return None
    keys, ci, pos, end, strand, seqno = (
        np.concatenate([p[i] for p in parts]) for i in range(6))
    order = np.lexsort((seqno, keys))
    keys, ci, pos, end, strand = (
        keys[order], ci[order], pos[order], end[order], strand[order])
    grp_start = np.empty(len(keys), bool)
    grp_start[0] = True
    np.not_equal(keys[1:], keys[:-1], out=grp_start[1:])
    gid = np.cumsum(grp_start) - 1
    cie = ci * 2 + end
    first_cie = cie[grp_start][gid]
    disagree = np.zeros(int(gid[-1]) + 1, bool)
    np.logical_or.at(disagree, gid, cie != first_cie)
    keep = grp_start & ~disagree[gid]
    return _EndIndexArrays(
        keys[keep], ci[keep], end[keep], pos[keep], strand[keep])


def _unmapped(R: int):
    return (np.zeros(R, np.int64), np.zeros(R, np.int8),
            np.zeros(R, np.int64), np.zeros(R, np.int8), np.zeros(R, bool))


def _map_reads_arrays_device(mat: np.ndarray, lens: np.ndarray,
                             idx: Optional[_EndIndexArrays], *,
                             k: int = SEED_K, stride: int = 7,
                             chunk: int = 1 << 20,
                             acgt_ok: Optional[np.ndarray] = None, device):
    """Device form of :func:`_map_reads_arrays`
    (``patching._map_reads_arrays_device``): the index goes up as int64
    keys (62 bits at k = 31), each read's forward seed keys at every
    ``stride``-th window are packed on ``device``, looked up with
    ``torch.searchsorted``, and the first valid hit is taken. Returns
    numpy ``(ci, end, pos5, strand, mapped)``."""
    R, L = mat.shape
    out_ci, out_end, out_pos, out_strand, mapped = _unmapped(R)
    if idx is None or len(idx.keys) == 0 or L < k:
        return out_ci, out_end, out_pos, out_strand, mapped
    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    keys = up(idx.keys.view(np.int64))
    ici, ipos = up(idx.ci.astype(np.int64)), up(idx.pos.astype(np.int64))
    iend, istrand = up(idx.end.astype(np.int64)), \
        up(idx.strand.astype(np.int64))
    nk = keys.numel()
    seeds = torch.arange(0, L - k + 1, stride, device=dev)
    for lo in range(0, R, chunk):
        m = up(mat[lo: lo + chunk])
        n = up(lens[lo: lo + chunk].astype(np.int64))[:, None]
        q = torch.zeros((m.shape[0], seeds.numel()), dtype=torch.int64,
                        device=dev)
        for j in range(k):
            q = (q << 2) | m[:, seeds + j].to(torch.int64)
        valid = (seeds < (n - k + 1).clamp(min=1)) & (seeds + k <= n)
        if acgt_ok is not None:
            valid &= up(acgt_ok[lo: lo + chunk][:, ::stride])
        p = torch.searchsorted(keys, q).clamp(max=nk - 1)
        hit = (keys[p] == q) & valid
        got = hit.any(dim=1)
        first = hit.to(torch.uint8).argmax(dim=1)
        e = p.gather(1, first[:, None]).squeeze(1)
        j = seeds[first]
        st = istrand[e]
        pos5 = torch.where(st == 0, ipos[e] - j, ipos[e] + k - 1 + j)
        sl = slice(lo, lo + m.shape[0])
        out_ci[sl] = torch.where(got, ici[e], 0).cpu().numpy()
        out_end[sl] = torch.where(got, iend[e], 0).cpu().numpy()
        out_pos[sl] = torch.where(got, pos5, 0).cpu().numpy()
        out_strand[sl] = torch.where(got, st, 0).cpu().numpy()
        mapped[sl] = got.cpu().numpy()
    return out_ci, out_end, out_pos, out_strand, mapped


def _map_reads_arrays(mat: np.ndarray, lens: np.ndarray,
                      idx: Optional[_EndIndexArrays], *, k: int = SEED_K,
                      stride: int = 7, chunk: int = 1 << 16,
                      acgt_ok: Optional[np.ndarray] = None, device):
    """First strided seed hit per read (``patching._map_reads_arrays``):
    the device form when the patching stage runs on the device, else this
    numpy oracle. ``acgt_ok`` is the (R, L-k+1) window mask in this
    matrix's orientation. Returns (ci, end, pos5, strand, mapped)."""
    if device_stage_default("patching"):
        return _map_reads_arrays_device(mat, lens, idx, k=k, stride=stride,
                                        acgt_ok=acgt_ok, device=device)
    R, L = mat.shape
    out_ci, out_end, out_pos, out_strand, mapped = _unmapped(R)
    if idx is None or len(idx.keys) == 0 or L < k:
        return out_ci, out_end, out_pos, out_strand, mapped
    seeds = np.arange(0, L - k + 1, stride, dtype=np.int64)
    nk = len(idx.keys)
    for lo in range(0, R, chunk):
        m = mat[lo: lo + chunk]
        n = lens[lo: lo + chunk].astype(np.int64)
        keys = rolling_window_values(m, k, want_rc=False)[0][:, seeds]
        valid = (seeds[None, :] < np.maximum(1, n[:, None] - k + 1)) & (
            seeds[None, :] + k <= n[:, None])
        if acgt_ok is not None:
            valid &= acgt_ok[lo: lo + chunk][:, seeds]
        p = np.minimum(np.searchsorted(idx.keys, keys), nk - 1)
        hit = (idx.keys[p] == keys) & valid
        got = hit.any(axis=1)
        first = np.argmax(hit, axis=1)
        e = p[np.arange(len(m)), first]
        j = seeds[first]
        pos5 = np.where(
            idx.strand[e] == 0, idx.pos[e] - j, idx.pos[e] + k - 1 + j)
        sl = slice(lo, lo + len(m))
        out_ci[sl] = np.where(got, idx.ci[e], 0)
        out_end[sl] = np.where(got, idx.end[e], 0)
        out_pos[sl] = np.where(got, pos5, 0)
        out_strand[sl] = np.where(got, idx.strand[e], 0)
        mapped[sl] = got
    return out_ci, out_end, out_pos, out_strand, mapped


def map_pairs(contigs: List[str], pairs: List[Tuple[str, str]], *,
              device) -> Tuple[tuple, np.ndarray]:
    """Map both mates of every pair to the contig ends: mate 1 forward,
    mate 2 as its reverse complement. Returns the ten arrays
    ``(c1, e1, p1, s1, ok1, c2, e2, p2, s2, ok2)`` and mate 2's lengths.
    Backends in the JAX package's order (``patching.py:514-537``): the
    hashed native call, the sorted native call, then the matrices through
    :func:`_map_reads_arrays` (device or numpy)."""
    from . import native

    native_ok = not device_stage_default("patching") and _native_patch_on()
    mapped = idx = None
    if native_ok and contigs:
        mapped = native.map_pairs_hashed_native(
            contigs, pairs, k=SEED_K, end_window=END_WINDOW, stride=7)
    if mapped is None:
        idx = _end_index_arrays(contigs)
    if mapped is None and idx is not None and native_ok:
        mapped = native.map_pairs_native(
            pairs, idx.keys, idx.ci, idx.end, idx.pos, idx.strand,
            k=SEED_K, stride=7)
    if mapped is not None:
        return mapped, np.fromiter((len(r2) for _, r2 in pairs), np.int64,
                                   count=len(pairs))
    a1, l1 = _ascii_matrix([r1 for r1, _ in pairs])
    a2, l2 = _ascii_matrix([r2 for _, r2 in pairs])
    m1, m2 = encode_ascii(a1), encode_ascii(a2)
    one = _map_reads_arrays(m1, l1, idx, acgt_ok=_window_acgt_ok(a1, SEED_K),
                            device=device)
    # mate 2 maps in reverse complement; ACGT-ness is complement-invariant,
    # so its mask is the row-reversed one
    a2r = np.zeros_like(a2)
    if a2.shape[1]:
        col = l2[:, None].astype(np.int64) - 1 - np.arange(a2.shape[1])
        a2r = np.where(
            col >= 0, a2[np.arange(len(l2))[:, None], np.clip(col, 0, None)],
            0).astype(np.uint8)
    two = _map_reads_arrays(revcomp_matrix(m2, l2), l2, idx,
                            acgt_ok=_window_acgt_ok(a2r, SEED_K),
                            device=device)
    return one + two, l2.astype(np.int64)


def _try_overlap_join(a: str, b: str, min_overlap: int) -> Optional[str]:
    """Join a's tail to b's head on the longest exact overlap (native
    memcmp scan when available; the same result)."""
    if os.environ.get("REFLEXIV_NATIVE_PATCH", "1") != "0":
        from . import native

        o = native.best_overlap_native(a.encode(), b.encode(), min_overlap)
        if o is not None:
            return a + b[o:] if o else None
    for o in range(min(len(a), len(b)), min_overlap - 1, -1):
        if a[-o:] == b[:o]:
            return a + b[o:]
    return None


def estimate_insert(samples: List[int]) -> Tuple[int, int]:
    """(median, MAD) of the insert distribution; prior when unobserved."""
    if len(samples) < 4:
        return DEFAULT_INSERT, DEFAULT_INSERT // 4
    med = int(statistics.median(samples))
    mad = int(statistics.median(abs(x - med) for x in samples)) or med // 10
    return med, mad


def read_pairs_from_params(params) -> List[Tuple[str, str]]:
    """Mate pairs from the command's read input, with preprocess's pairing
    rules (``ReflexivDataFrameDecompresser``): ``-inter`` pairs consecutive
    records; exactly two input files pair file1[i] with file2[i]. Anything
    else is unpaired -> []."""
    from .io import expand_paths, iter_fastq

    if not params.input_fastq:
        return []
    paths = expand_paths(params.input_fastq)
    if params.interleaved:
        rs = [r.decode() for r in iter_fastq(paths)]
        return list(zip(rs[0::2], rs[1::2]))
    if len(paths) == 2:
        r1 = [r.decode() for r in iter_fastq([paths[0]])]
        r2 = [r.decode() for r in iter_fastq([paths[1]])]
        if len(r1) != len(r2):
            log.warning(
                "patching: two input files with unequal read counts "
                "(%d vs %d) — not treating as mate pair", len(r1), len(r2))
            return []
        return list(zip(r1, r2))
    return []


def apply_patching(contigs, params, *, device):
    """The patching stage over emitted ``(header, seq)`` contigs: recover
    the mate pairs from the input reads, vote for connections,
    join/scaffold. Returns (contigs, link rows); a no-op with a log line
    when the input is not paired. Times ``patching/read_pairs`` here and
    ``patching/map`` / ``patching/join`` in :func:`patch_contigs`."""
    t0 = time.perf_counter()
    pairs = read_pairs_from_params(params)
    metrics.current().add_time("patching/read_pairs",
                               time.perf_counter() - t0)
    if not pairs:
        log.info("patching: input is not paired; stage skipped")
        return list(contigs), []
    seqs = [s for _, s in contigs]
    patched, links = patch_contigs(seqs, pairs, scaffold=params.scaffold,
                                   device=device)
    out = [(f">Contig-{len(s)}-(0,0)-{i}", s) for i, s in enumerate(patched)]
    log.info("patching: %d contigs -> %d (%d supported links)",
             len(seqs), len(out), len(links))
    return out, links


def patch_contigs(
    contigs: List[str],
    pairs: List[Tuple[str, str]],
    *,
    min_links: int = MIN_LINKS,
    min_overlap: int = MIN_OVERLAP,
    scaffold: bool = False,
    device,
) -> Tuple[List[str], List[Tuple[int, int, int, int, int, int]]]:
    """Connect contigs supported by read-pair links
    (``patching.patch_contigs``). Returns (contigs after the executable
    joins, link rows ``(contig_a, end_a, contig_b, end_b, n_links, gap)``
    for every supported connection, joined or not). ``gap`` < 0 means the
    ends are expected to overlap. With ``scaffold``, supported links
    without an exact overlap join through ``max(gap, MIN_GAP_N)`` Ns."""
    met = metrics.current()
    t0 = time.perf_counter()
    (c1, _e1, p1, s1, ok1, c2, _e2, p2, s2, ok2), len2 = map_pairs(
        contigs, pairs, device=device)
    t1 = time.perf_counter()
    met.add_time("patching/map", t1 - t0)
    ok = ok1 & ok2

    # same-contig, strand-consistent pairs observe the insert size
    sm = ok & (c1 == c2) & (s1 == s2)
    ins = np.where(s1 == 0, p2 + len2 - p1, p1 - p2 + len2)[sm]
    inserts = [int(x) for x in ins[(ins > 0) & (ins <= 4 * DEFAULT_INSERT)]]
    ins_med, ins_mad = estimate_insert(inserts)

    # cross-contig pairs vote for the junction their fragment implies
    x = np.nonzero(ok & (c1 != c2))[0]
    supported: List[Tuple[Tuple[int, int], Tuple[int, int], int, int]] = []
    if len(x):
        clen = np.asarray([len(s) for s in contigs], np.int64)
        xc1, xp1, xs1 = c1[x], p1[x], s1[x]
        xc2, xp2, xs2 = c2[x], p2[x], s2[x]
        xl2 = len2[x]
        end1 = np.where(xs1 == 0, 1, 0).astype(np.int64)
        d1 = np.where(xs1 == 0, clen[xc1] - xp1, xp1 + 1)
        end2 = np.where(xs2 == 0, 0, 1).astype(np.int64)
        d2 = np.where(xs2 == 0, xp2 + xl2, clen[xc2] - xp2 + xl2 - 1)
        pa, pb = xc1 * 2 + end1, xc2 * 2 + end2
        swap = pb < pa
        packed = (np.where(swap, pb, pa) << np.int64(32)) | \
            np.where(swap, pa, pb)
        gapv = np.int64(ins_med) - d1 - d2
        uniq, first, inv, cnt = np.unique(
            packed, return_index=True, return_inverse=True,
            return_counts=True)
        order = np.lexsort((gapv, inv))
        starts = np.zeros(len(uniq), np.int64)
        np.cumsum(cnt[:-1], out=starts[1:])
        med = gapv[order][starts + cnt // 2]     # the upper median
        for u in np.argsort(first, kind="stable"):   # first-seen link order
            n = int(cnt[u])
            if n < min_links:
                continue
            gap = int(med[u])
            # implausible geometry: a fragment cannot bridge ends further
            # apart than the insert allows, nor overlap deeper than a
            # whole end window
            if gap > ins_med + 3 * ins_mad or gap < -END_WINDOW:
                continue
            key = int(uniq[u])
            a_p, b_p = key >> 32, key & 0xFFFFFFFF
            supported.append(
                ((a_p // 2, a_p % 2), (b_p // 2, b_p % 2), n, gap))
    out = _filter_and_join(contigs, supported, min_overlap, scaffold)
    met.add_time("patching/join", time.perf_counter() - t1)
    return out


def _filter_and_join(contigs, supported, min_overlap, scaffold):
    """Unique-partner filter, then join/scaffold over the supported links
    in order (``patching._filter_and_join``)."""
    # unique-partner filter: an end may join at most one other end
    end_use: Counter = Counter()
    for a, b, _n, _g in supported:
        end_use[a] += 1
        end_use[b] += 1
    supported = [(a, b, n, g) for a, b, n, g in supported
                 if end_use[a] == 1 and end_use[b] == 1]

    links = [(a[0], a[1], b[0], b[1], n, g) for a, b, n, g in supported]
    out = list(contigs)
    dead = set()
    for (ca, ea), (cb, eb), _n, g in supported:
        if ca in dead or cb in dead:
            continue
        # orient: join tail(a-oriented) -> head(b-oriented)
        sa = out[ca] if ea == 1 else revcomp_str(out[ca])
        sb = out[cb] if eb == 0 else revcomp_str(out[cb])
        joined = _try_overlap_join(sa, sb, min_overlap)
        if joined is not None:
            out[ca] = joined
            dead.add(cb)
            log.info("patching: joined contig %d and %d (overlap)", ca, cb)
        elif scaffold:
            out[ca] = sa + "N" * max(g, MIN_GAP_N) + sb
            dead.add(cb)
            log.info("patching: scaffolded contig %d and %d (gap %d)",
                     ca, cb, g)
    return [s for i, s in enumerate(out) if i not in dead], links
