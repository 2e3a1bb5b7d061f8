"""Edge-free de Bruijn graph construction: RC expansion + fork filtering
(PyTorch counterpart of ``reflexiv_tpu.graph``).

Every counted canonical k-mer is expanded to both strands
(``ReflexivDSMain.java:3840-3870``); rows are grouped by their (k-1)-base
prefix, the highest-(coverage, extension base) row wins and its right end
is marked blocked or extendable by the error-correction rule
(``ReflexivDSMain.java:3425-3484``); the same selection on (k-1)-base
suffix groups marks the left end (``:3543-3617``). The second pass runs in
the first pass's sorted order, so the output rows come in the same order as
the JAX package's. For k >= 32 the group keys are several words
(``bitpack``); a dead row's key copies the JAX all-ones limbs, including
their tie with poly-T where the group width is a multiple of 16
(``bitpack.group_sentinel``).
"""
from __future__ import annotations

import torch

from .bitpack import (group_sentinel, pack_bases, revcomp_bases,
                      unpack_bases, where_live)
from .join_core import lexsort_rows, segment_sum, segments
from .records import Records


def _fork_pass(bases, cover, valid, *, lo, hi, ext_col, min_error, blocked,
               carry=None):
    """One fork-filter pass grouping on ``bases[:, lo:hi]`` with the variant
    base at ``ext_col``. Returns (bases, cover, winner, attr, carry) in this
    pass's sorted order."""
    N = bases.shape[0]
    width = hi - lo
    keyed = where_live(valid, pack_bases(bases[:, lo:hi], width),
                       group_sentinel(width))
    ext = bases[:, ext_col].to(torch.int64)
    # key asc, then coverage desc, then ext desc -> group winner first
    order = lexsort_rows(keyed, -4 * cover.to(torch.int64) - ext)
    sbases, scover, svalid = bases[order], cover[order], valid[order]
    is_start, seg = segments(keyed[order])

    group_size = segment_sum(svalid.to(torch.int64), seg, N)
    win_cover = torch.full((N,), -1, dtype=torch.int32, device=bases.device)
    win_cover.scatter_reduce_(0, seg, torch.where(svalid, scover, -1), "amax")
    killable = (scover <= min_error) & (win_cover[seg] >= 2 * scover)
    loser_ok = torch.where(is_start | ~svalid, 1, killable.to(torch.int32))
    all_killable = torch.ones(N, dtype=torch.int32, device=bases.device)
    all_killable.scatter_reduce_(0, seg, loser_ok, "amin")

    winner = is_start & svalid
    extendable = (group_size[seg] == 1) | (all_killable[seg] > 0)
    # clamp the coverage tag so extreme coverage can never reach the
    # REPEAT_KILLED sentinel (records.py)
    attr = torch.where(extendable, -1 - torch.clamp(scover, max=100_000),
                       blocked).to(torch.int32)
    scarry = carry[order] if carry is not None else None
    return sbases, scover, winner, attr, scarry


def build_initial_records(
    keys: torch.Tensor,     # (U,) int64 canonical k-mers, or (U, W) words
    counts: torch.Tensor,   # (U,) int32
    *,
    k: int,
    min_error: int,
    bubble: bool = True,
) -> Records:
    """Counted canonical k-mers -> fork-filtered two-strand record set.

    Every live record is a full k-mer (length k) in reflected
    representation, as the state entering ``DSkmerRandomReflection``
    (``ReflexivDSMain.java:241-259``). Row order is pass-2 sorted order."""
    sub = k - 1
    bases_f = unpack_bases(keys, k)
    bases = torch.cat([bases_f, revcomp_bases(bases_f)])
    cover = torch.cat([counts, counts]).to(torch.int32)
    valid = torch.ones(bases.shape[0], dtype=torch.bool, device=keys.device)
    length = torch.full((bases.shape[0],), k, dtype=torch.int32,
                        device=keys.device)

    if not bubble:
        # ``-bubble`` skips both fork-filter stages (ReflexivDSMain.java:231-253)
        return Records(bases, length, cover, cover.clone(), valid)

    # pass 1: prefix groups -> right-end attr
    bases1, cover1, win1, right1, _ = _fork_pass(
        bases, cover, valid, lo=0, hi=sub, ext_col=k - 1,
        min_error=min_error, blocked=sub)
    # pass 2: suffix groups over pass-1 survivors -> left-end attr, in
    # pass-1 sorted space with the right attrs riding the permutation
    bases2, _cover2, win2, left2, right2 = _fork_pass(
        bases1, cover1, win1, lo=1, hi=k, ext_col=0,
        min_error=min_error, blocked=sub, carry=right1)
    return Records(bases2, length, left2, right2, win2)
