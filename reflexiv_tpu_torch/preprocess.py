"""Read preprocessing: pair overlap merging and k-mer-spectrum error
correction (``reflexiv_tpu.preprocess``).

The reference's preprocess pipeline (``MainOfPreProcessing`` ->
``ReflexivDataFrameDecompresser`` / ``ReflexivDataFrameErrorCorrecter``)
shells out to flash (pair merging, ``ReflexivDataFrameDecompresser.java
:475-542``) and lighter (correction, ``ReflexivDataFrameErrorCorrecter.java
:551-633``). Here:

  * pair merging takes, per pair, the overlap o in [10, min(l1, l2)] of
    mate 1's suffix with mate 2's reverse complement of lowest mismatch
    density (at most 0.25; ties to the longer overlap), through the native
    library's ``rfx_merge_pairs``, else a numpy loop over o;
  * correction substitutes a base that no solid k-mer covers when exactly
    one alternative makes every covering window solid. It has three
    forms, chosen as the JAX package chooses them: the device form when
    ``device_aux.device_stage_default("correction")`` says so
    (``REFLEXIV_DEVICE_STAGES`` set and not 0); else the native in-order
    scan (``rfx_correct``) unless ``REFLEXIV_NATIVE_CORRECT=0``,
    ``REFLEXIV_DEVICE_STAGES=0`` or k > 31; else the numpy passes.

The device form keeps the read matrix on the device. Window solidity is
the extraction kernel over every read window, looked up in the sorted
solid table (``mercy.lookup_counts``), then a row ``cumsum``; each
candidate's 2k-1 base segment is cut again by the extraction kernel with
each of the four bases at its centre. By default one dispatch per round
selects the first ``REFLEXIV_DISPATCH_CAP`` (2^20) weak positions not yet
attempted in row-major order, evaluates them against the matrix as it was
before the dispatch and writes the unique fixes in place; only counts
reach the host. ``REFLEXIV_SINGLE_DISPATCH=0`` takes the chunked form,
whose weak mask goes to the host and whose chunks of 2^16 candidates see
the fixes of the chunks before them.
"""
from __future__ import annotations

import logging
import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import metrics
from .bitpack import (CODE_TO_BASE, encode_ascii, num_limbs, num_words,
                      revcomp_matrix, rolling_window_values)
from .count import count_kmers_auto
from .device import resolve_device
from .mercy import window_counts
from .params import Params

log = logging.getLogger("reflexiv_tpu_torch")

FLASH_MIN_OVERLAP = 10       # flash -m default
FLASH_MAX_MISMATCH = 0.25    # flash -x default


def merge_pairs(m1: np.ndarray, l1: np.ndarray, m2: np.ndarray,
                l2: np.ndarray, *, min_overlap: int = FLASH_MIN_OVERLAP,
                max_mismatch: float = FLASH_MAX_MISMATCH
                ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Overlap-merge read pairs (mate 1 forward, mate 2 reverse strand):
    returns the code arrays, ``[merged]`` or ``[r1, r2]`` per pair in pair
    order, and the merged mask."""
    from .native import merge_pairs_native

    P = m1.shape[0]
    if m2.shape[0] != P:
        raise ValueError(f"{P} first mates but {m2.shape[0]} second mates")
    L1, L2 = m1.shape[1], m2.shape[1]
    rows = np.arange(P)[:, None]
    r2rc = revcomp_matrix(m2, l2)
    best_o = merge_pairs_native(m1, l1, m2, l2, min_overlap=min_overlap,
                                max_mismatch=max_mismatch)
    if best_o is None:
        best_o = np.zeros(P, np.int32)
        best_mm = np.full(P, 1.0, np.float64)
        for o in range(min_overlap, int(min(L1, L2)) + 1):
            ok = (l1 >= o) & (l2 >= o)
            if not ok.any():
                continue
            cols = l1[:, None].astype(np.int64) - o + np.arange(o)[None, :]
            a = m1[rows, np.clip(cols, 0, L1 - 1)]
            mm = np.count_nonzero(a != r2rc[:, :o], axis=1) / o
            better = ok & (mm <= max_mismatch) & (
                (mm < best_mm) | ((mm == best_mm) & (o > best_o)))
            best_o[better] = o
            best_mm[better] = mm[better]
    merged_mask = best_o >= min_overlap
    out: List[np.ndarray] = []
    for i in range(P):
        if merged_mask[i]:
            out.append(np.concatenate([m1[i, :l1[i]],
                                       r2rc[i, best_o[i]:l2[i]]]))
        else:
            out.append(m1[i, :l1[i]])
            out.append(r2rc[i, :l2[i]])
    return out, merged_mask


def _solid_table(mat, lens, k: int, min_cov: int, *, device,
                 plain: bool = False):
    """The solid k-mers (count >= ``min_cov``): ``(sorted uint64 values,
    keys, counts)``. The values are the JAX package's ``(hi << 32) | lo``
    of the k-mer's two limbs, the canonical k-mer as one 2k-bit integer;
    keys and counts are :func:`count.count_kmers`' table on ``device``."""
    if num_limbs(k) > 2:
        raise ValueError("correction supports k <= 31")
    keys, counts = count_kmers_auto(mat, lens, k=k, min_cov=min_cov,
                               device=device, plain=plain)
    kn = keys.cpu().numpy()
    if num_words(k) == 1:
        vals = kn.astype(np.uint64)
    else:     # k = 32: a 62-bit first word and one base
        vals = (kn[:, 0].astype(np.uint64) << np.uint64(2)) \
            | kn[:, 1].astype(np.uint64)
    return vals, keys, counts


def _window_solidity(dmat: torch.Tensor, dlens: torch.Tensor, k: int,
                     keys, counts, plain: bool = False):
    """``(solid, valid, csum)`` over every read window on the device:
    each window's table count (:func:`mercy.window_counts`) > 0, the
    window valid, and the row prefix sums of solidity, ``(R, Wn + 1)``."""
    R, L = dmat.shape
    c, _pos, valid = window_counts(dmat, dlens, keys, counts, k=k,
                                   plain=plain)
    valid = valid.view(R, L - k + 1)
    solid = (c > 0).view(R, L - k + 1) & valid
    csum = F.pad(torch.cumsum(solid, 1, dtype=torch.int32), (1, 0))
    return solid, valid, csum


def _weak_mask(dmat, dlens, k: int, keys, counts, plain: bool = False):
    """(R, L) bool: positions of reads of at least k + 1 bases that no
    solid window covers (``preprocess._device_fns``' ``weak_mask``)."""
    R, L = dmat.shape
    _solid, _valid, csum = _window_solidity(dmat, dlens, k, keys, counts,
                                            plain)
    n = dlens.to(torch.int64)[:, None]
    p = torch.arange(L, device=dmat.device)[None, :]
    w_lo = (p - k + 1).clamp(min=0).expand(R, L)
    w_hi = torch.minimum(n - k + 1, p + 1)
    covered = torch.gather(csum, 1, w_hi.clamp(min=0)) \
        - torch.gather(csum, 1, w_lo)
    return (covered == 0) & (p < n) & (n >= k + 1) & (w_hi > w_lo)


def _candidate_eval(dmat, dlens, ic, pc, k: int, keys, counts,
                    plain: bool = False):
    """Per candidate (read ``ic``, position ``pc``): how many of the three
    other bases make every in-read window over ``pc`` solid, and the last
    such base (``candidate_eval``). The k windows of a position lie in the
    2k-1 bases around it; that segment matrix goes through the extraction
    kernel once per base at its centre column."""
    N, L = ic.shape[0], dmat.shape[1]
    dev = dmat.device
    pc = pc.to(torch.int64)
    cols = (pc[:, None] + torch.arange(-(k - 1), k, device=dev)[None, :]) \
        .clamp(0, L - 1)
    seg = dmat[ic[:, None], cols]
    lo_w = (pc - k + 1).clamp(min=0)
    hi_w = torch.minimum(dlens[ic].to(torch.int64) - k + 1, pc + 1)
    starts = (pc - k + 1)[:, None] + torch.arange(k, device=dev)[None, :]
    w_ok = (starts >= lo_w[:, None]) & (starts < hi_w[:, None])
    orig = dmat[ic, pc]
    seg_lens = torch.full((N,), 2 * k - 1, dtype=torch.int32, device=dev)
    ok_count = torch.zeros(N, dtype=torch.int32, device=dev)
    fix_base = torch.zeros(N, dtype=torch.uint8, device=dev)
    for b in range(4):
        seg[:, k - 1] = b
        c, _pos, _valid = window_counts(seg, seg_lens, keys, counts, k=k,
                                        plain=plain)
        all_solid = ((c > 0).view(N, k) | ~w_ok).all(1)
        cand = all_solid & (orig != b)
        ok_count += cand.to(torch.int32)
        fix_base = torch.where(cand, b, fix_base).to(torch.uint8)
    return ok_count, fix_base


def _next_pow2(n: int, floor: int = 4096) -> int:
    cap = floor
    while cap < n:
        cap <<= 1
    return cap


def _fix_round(dmat, dlens, attempted, keys, counts, quals, trust: int,
               k: int, cap: int, plain: bool = False):
    """One device dispatch (``fix_round``): the weak scan, the first ``cap``
    weak positions not yet attempted in row-major order, their evaluation
    against the matrix as it stands, and the unique fixes written in
    place. Updates ``dmat`` and ``attempted``; returns (fixes as a 0-dim
    tensor, candidates selected)."""
    L = dmat.shape[1]
    weak = _weak_mask(dmat, dlens, k, keys, counts, plain)
    if quals is not None:
        weak &= quals < trust
    weak &= ~attempted
    sel = torch.nonzero(weak.view(-1)).squeeze(1)[:cap]
    if not sel.numel():
        return torch.zeros((), dtype=torch.int64), 0
    ic, pc = sel // L, sel % L
    ok_count, fix_base = _candidate_eval(dmat, dlens, ic, pc, k, keys,
                                         counts, plain)
    unique = ok_count == 1
    dmat[ic, pc] = torch.where(unique, fix_base, dmat[ic, pc])
    attempted.view(-1)[sel] = True
    return unique.sum(), sel.numel()


def _fix_pass_device(dmat, dlens, k: int, keys, counts, *,
                     chunk: int = 1 << 16, quals=None, trust_qual: int = 0,
                     plain: bool = False):
    """One chunked correction pass (``_fix_pass_device``): the weak mask
    to the host, then chunks of ``chunk`` candidates in row-major order,
    each evaluated on the device against the matrix with the earlier
    chunks' fixes. Returns (fixes, fixed rows)."""
    weak = _weak_mask(dmat, dlens, k, keys, counts, plain).cpu().numpy()
    if quals is not None and trust_qual > 0:
        weak = weak & (quals < trust_qual)
    ii, pp = np.nonzero(weak)
    n_fixed, fixed_rows = 0, []
    for lo in range(0, len(ii), chunk):
        ic = torch.from_numpy(ii[lo:lo + chunk]).to(dmat.device)
        pc = torch.from_numpy(pp[lo:lo + chunk]).to(dmat.device)
        ok_count, fix_base = _candidate_eval(dmat, dlens, ic, pc, k, keys,
                                             counts, plain)
        unique = ok_count == 1
        dmat[ic[unique], pc[unique]] = fix_base[unique]
        got = int(unique.sum())
        if got:
            fixed_rows.append(ic[unique].cpu().numpy())
        n_fixed += got
    rows = (np.unique(np.concatenate(fixed_rows)) if fixed_rows
            else np.zeros(0, np.int64))
    return n_fixed, rows


def correct_reads_device(mat: np.ndarray, lens: np.ndarray, *, k: int = 23,
                         min_cov: int = 2, max_rounds: int = 4,
                         quals: np.ndarray = None, trust_qual: int = 0,
                         device, plain: bool = False
                         ) -> Tuple[np.ndarray, int]:
    """The device form of :func:`correct_reads` (``correct_reads_device``):
    up to ``max_rounds`` rounds over a device-resident read matrix, the
    single dispatch per round unless ``REFLEXIV_SINGLE_DISPATCH=0``.
    ``plain=True`` cuts the windows and counts through the kernels' plain
    torch versions. Returns (corrected matrix, bases fixed)."""
    device = resolve_device(device)
    _vals, keys, counts = _solid_table(mat, lens, k, min_cov, device=device,
                                       plain=plain)
    if counts.numel() == 0:
        return mat.copy(), 0
    dmat = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
    dlens = torch.from_numpy(lens.astype(np.int32)).to(device)
    n_fixed = 0
    if os.environ.get("REFLEXIV_SINGLE_DISPATCH", "1") != "0":
        R, L = mat.shape
        cap = min(int(os.environ.get("REFLEXIV_DISPATCH_CAP", 1 << 20)),
                  _next_pow2(R * L))
        dq = (torch.from_numpy(np.ascontiguousarray(quals)).to(device)
              if quals is not None and trust_qual > 0 else None)
        attempted = torch.zeros((R, L), dtype=torch.bool, device=device)
        for _ in range(max_rounds):
            round_fixed = 0
            while True:
                got, n_sel = _fix_round(dmat, dlens, attempted, keys, counts,
                                        dq, trust_qual, k, cap, plain)
                round_fixed += int(got)
                if n_sel < cap:
                    break
            n_fixed += round_fixed
            if round_fixed == 0:
                break
            attempted.zero_()
        return dmat.cpu().numpy(), n_fixed
    for _ in range(max_rounds):
        got, _rows = _fix_pass_device(dmat, dlens, k, keys, counts,
                                      quals=quals, trust_qual=trust_qual,
                                      plain=plain)
        n_fixed += got
        if got == 0:
            break
    return dmat.cpu().numpy(), n_fixed


def _fix_pass(mat: np.ndarray, lens: np.ndarray, k: int,
              solid_sorted: np.ndarray, keys, counts, *,
              chunk: int = 1 << 16, quals: np.ndarray = None,
              trust_qual: int = 0, device, plain: bool = False):
    """One simultaneous numpy correction pass (``preprocess._fix_pass``,
    the oracle): every position covered by no solid window, all three
    substitutions tested at once against the sorted solid values, the
    unique fixes applied in place. Window solidity is found on ``device``.
    Returns (fixes, unique fixed rows)."""
    R, L = mat.shape
    dmat = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
    dlens = torch.from_numpy(lens.astype(np.int32)).to(device)
    csum = _window_solidity(dmat, dlens, k, keys, counts, plain)[2] \
        .cpu().numpy()
    n = lens.astype(np.int64)
    p = np.arange(L, dtype=np.int64)
    w_lo = np.maximum(0, p - k + 1)[None, :]
    w_hi = np.minimum((n - k + 1)[:, None], p[None, :] + 1)
    covered = np.take_along_axis(csum, np.maximum(w_hi, 0), axis=1) - \
        np.take_along_axis(csum, np.broadcast_to(w_lo, w_hi.shape), axis=1)
    weak = (covered == 0) & (p[None, :] < n[:, None]) & \
        (n[:, None] >= k + 1) & (w_hi > w_lo)
    if quals is not None and trust_qual > 0:
        weak = weak & (quals < trust_qual)
    ii, pp = np.nonzero(weak)
    if not len(ii):
        return 0, np.zeros(0, np.int64)
    n_fixed, fixed_rows = 0, []
    seg_w = 2 * k - 1
    for lo_c in range(0, len(ii), chunk):
        ic, pc = ii[lo_c:lo_c + chunk], pp[lo_c:lo_c + chunk]
        N = len(ic)
        lo_w = np.maximum(0, pc - k + 1)
        hi_w = np.minimum(lens[ic].astype(np.int64) - k + 1, pc + 1)
        cols = np.clip((pc - k + 1)[:, None] + np.arange(seg_w)[None, :],
                       0, L - 1)
        seg = mat[ic[:, None], cols]
        starts = (pc - k + 1)[:, None] + np.arange(k, dtype=np.int64)[None, :]
        w_ok = (starts >= lo_w[:, None]) & (starts < hi_w[:, None])
        orig = mat[ic, pc]
        ok_count = np.zeros(N, np.int8)
        fix_base = np.zeros(N, np.uint8)
        for b in range(4):
            seg[:, k - 1] = b
            fwd, rc = rolling_window_values(seg, k)
            canon = np.minimum(fwd, rc)
            if len(solid_sorted):
                pos = np.minimum(np.searchsorted(solid_sorted, canon),
                                 len(solid_sorted) - 1)
                member = solid_sorted[pos] == canon
            else:
                member = np.zeros(canon.shape, bool)
            cand = np.logical_or(member, ~w_ok).all(axis=1) & (orig != b)
            ok_count += cand
            fix_base = np.where(cand, b, fix_base)
        unique = ok_count == 1
        mat[ic[unique], pc[unique]] = fix_base[unique]
        n_fixed += int(unique.sum())
        if unique.any():
            fixed_rows.append(ic[unique])
    rows = (np.unique(np.concatenate(fixed_rows)) if fixed_rows
            else np.zeros(0, np.int64))
    return n_fixed, rows


def correct_reads(mat: np.ndarray, lens: np.ndarray, *, k: int = 23,
                  min_cov: int = 2, max_rounds: int = 4,
                  quals: np.ndarray = None, trust_qual: int = 0, device,
                  plain: bool = False) -> Tuple[np.ndarray, int]:
    """K-mer-spectrum single-base correction (``preprocess.correct_reads``):
    returns (corrected matrix, bases fixed); the input is not changed. The
    form is chosen as the module docstring says. The solid table is
    counted on ``device`` in every form."""
    from .device_aux import device_stage_default

    if device_stage_default("correction"):
        return correct_reads_device(
            mat, lens, k=k, min_cov=min_cov, max_rounds=max_rounds,
            quals=quals, trust_qual=trust_qual, device=device, plain=plain)
    device = resolve_device(device)
    solid_sorted, keys, counts = _solid_table(mat, lens, k, min_cov,
                                              device=device, plain=plain)
    if (os.environ.get("REFLEXIV_NATIVE_CORRECT", "1") != "0"
            and os.environ.get("REFLEXIV_DEVICE_STAGES") != "0"
            and k <= 31):
        from .native import correct_reads_native

        out = correct_reads_native(mat.copy(), lens, solid_sorted, k=k,
                                   quals=quals, trust_qual=trust_qual)
        if out is not None:
            return out
    mat = mat.copy()
    n_fixed = 0
    rows = None      # None: the whole matrix (first round)
    for _ in range(max_rounds):
        if rows is None:
            got, rows = _fix_pass(mat, lens, k, solid_sorted, keys, counts,
                                  quals=quals, trust_qual=trust_qual,
                                  device=device, plain=plain)
        else:
            # a fix changes only its own read's windows, so later rounds
            # revisit the rows fixed in the round before
            if not len(rows):
                break
            sub = np.ascontiguousarray(mat[rows])
            got, sub_rows = _fix_pass(
                sub, lens[rows], k, solid_sorted, keys, counts,
                quals=quals[rows] if quals is not None else None,
                trust_qual=trust_qual, device=device, plain=plain)
            mat[rows] = sub
            rows = rows[sub_rows]
        n_fixed += got
        if got == 0:
            break
    return mat, n_fixed


def correct_reads_scalar(mat: np.ndarray, lens: np.ndarray, *, k: int = 23,
                         min_cov: int = 2, device="cpu"
                         ) -> Tuple[np.ndarray, int]:
    """The per-read in-order scan (``correct_reads_scalar``), an oracle for
    the tests: each flagged read left to right, each substitution tested
    against the solid set one window at a time."""
    solid_sorted, keys, counts = _solid_table(mat, lens, k, min_cov,
                                              device=device)
    solid = set(int(x) for x in solid_sorted)

    def canon_val(window: np.ndarray) -> int:
        v = rc = 0
        for b in window:
            v = (v << 2) | int(b)
        for b in window[::-1]:
            rc = (rc << 2) | (3 ^ int(b))
        return min(v, rc)

    dmat = torch.from_numpy(np.ascontiguousarray(mat)).to(keys.device)
    dlens = torch.from_numpy(lens.astype(np.int32)).to(keys.device)
    solid_w, valid_w, csum = (t.cpu().numpy() for t in _window_solidity(
        dmat, dlens, k, keys, counts))
    has_weak = (valid_w & ~solid_w).any(axis=1)
    mat = mat.copy()
    n_fixed = 0
    for i in np.nonzero(has_weak)[0]:
        n = int(lens[i])
        if n < k + 1:
            continue
        read = mat[i, :n]
        W = n - k + 1
        row = csum[i]
        for p in range(n):
            w_lo, w_hi = max(0, p - k + 1), min(W, p + 1)
            if row[w_hi] - row[w_lo] > 0:
                continue
            orig = read[p]
            fixes = []
            for b in range(4):
                if b == orig:
                    continue
                read[p] = b
                if all(canon_val(read[w:w + k]) in solid
                       for w in range(w_lo, w_hi)):
                    fixes.append(b)
                read[p] = orig
            if len(fixes) == 1:
                read[p] = fixes[0]
                n_fixed += 1
    return mat, n_fixed


def _write_fastq(path: str, reads: List[np.ndarray]) -> None:
    """``@read-<i>`` records with 'I' qualities, as the JAX writer."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        for i, codes in enumerate(reads):
            seq = CODE_TO_BASE[codes].tobytes().decode()
            fh.write(f"@read-{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def preprocess(params: Params, *, device, plain: bool = False) -> None:
    """The ``preprocess`` command (``preprocess.preprocess``): pairs merge
    when the input is interleaved (``-inter``, consecutive records are
    mates; ``Read_Interleaved_Merged``) or exactly two files
    (``Read_Paired_Merged``); then every read is corrected at k =
    min(23, -kmer) with min_cov = max(2, -cover) into
    ``Read_Repartitioned``. ``-trustqual`` gates unpaired input only.
    ``plain=True`` counts and cuts windows through the kernels' plain
    torch versions. Counters ``preprocess/pairs``,
    ``preprocess/pairs_merged``, ``preprocess/reads`` and
    ``preprocess/bases_fixed``."""
    from .io import (expand_paths, iter_fastq, load_reads_with_quals,
                     reads_to_matrix, write_success_marker)

    device = resolve_device(device)
    met = metrics.current()
    paths = expand_paths(params.input_fastq or params.input_fasta)
    out = params.output_path
    pair_lists = None
    if params.interleaved:
        all_reads = list(iter_fastq(paths))
        if len(all_reads) % 2:
            raise SystemExit(
                "error: interleaved input holds an odd number of records")
        pair_lists = (all_reads[0::2], all_reads[1::2])
        merged_dir = "Read_Interleaved_Merged"
    elif len(paths) == 2:
        pair_lists = (list(iter_fastq([paths[0]])),
                      list(iter_fastq([paths[1]])))
        if len(pair_lists[0]) != len(pair_lists[1]):
            raise SystemExit("error: paired inputs differ in read count")
        merged_dir = "Read_Paired_Merged"
    if pair_lists is not None:
        r1, r2 = pair_lists
        m1, l1 = reads_to_matrix(r1)
        m2, l2 = reads_to_matrix(r2)
        reads, mask = merge_pairs(m1, l1, m2, l2)
        log.info("pair merging: %d/%d pairs merged", int(mask.sum()),
                 len(r1))
        met.set("preprocess/pairs", len(r1))
        met.set("preprocess/pairs_merged", int(mask.sum()))
        mdir = os.path.join(out, merged_dir)
        _write_fastq(os.path.join(mdir, "part-00000.fq"), reads)
        write_success_marker(mdir)
    else:
        reads = [encode_ascii(np.frombuffer(s, np.uint8))
                 for s in iter_fastq(paths)]
    mat, lens = reads_to_matrix([CODE_TO_BASE[r].tobytes() for r in reads])
    quals = None
    if params.trust_quality > 0 and pair_lists is None:
        # pair-merged reads have composite quality profiles and stay
        # coverage-only
        qmat, qlens, qq = load_reads_with_quals(
            params.input_fastq or params.input_fasta)
        if qmat.shape == mat.shape and np.array_equal(qlens, lens):
            quals = qq
        else:
            log.warning("quality column misaligned; coverage-only "
                        "correction")
    corrected, n_fixed = correct_reads(
        mat, lens, k=min(23, params.k),
        min_cov=max(2, params.min_kmer_coverage), quals=quals,
        trust_qual=params.trust_quality, device=device, plain=plain)
    log.info("error correction: %d bases fixed", n_fixed)
    met.set("preprocess/reads", len(lens))
    met.set("preprocess/bases_fixed", n_fixed)
    rdir = os.path.join(out, "Read_Repartitioned")
    _write_fastq(os.path.join(rdir, "part-00000.fq"),
                 [corrected[i, :lens[i]] for i in range(len(lens))])
    write_success_marker(rdir)
