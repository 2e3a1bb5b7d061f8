"""Stage checkpoints of ``meta`` (``reflexiv_tpu.checkpoint``, same files).

The reference resumes its staged pipeline from the newest stage directory
holding ``_SUCCESS`` (``checkStepsForDynamicAssemblyPipe``,
``Pipelines.java:613-830``); :func:`latest_stage` scans the stage list
backwards and :func:`clear_from` drops a stage and every later one.

The formats are the JAX package's, so a stage written by either package
resumes in the other:
  * ``packed_v2``: a pool as ``block_*.npz`` files of at most 2^20 live
    rows each (2-bit packed limbs, length, subk, left, right, live) plus
    ``meta.json``; a :class:`packed_dyn.FlatPool` is written in blocks of
    consecutive rows each as wide as its own longest row (at most
    ``BLOCK_LIMBS`` limbs a block, so a megabase row gets a block of its
    own), which the JAX reader takes as it takes its own;
  * ``groups_v1``: a width-class group list, one ``g_*.npz`` per group;
  * per-k sets (``set.npz``), in-loop state (``it_<n>/``: pool groups or
    blocks, parked groups, ``state.json``) and contigs with their attrs
    (``contigs.txt``, ``left<TAB>right<TAB>seq`` lines).
"""
from __future__ import annotations

import glob
import json
import logging
import os
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from . import packed_dyn as pd
from .dyn_pool import (DynRecords, PackedDynRecords, limbs_for,
                       pack_seq_matrix_np, unpack_seq_matrix_np)
from .io import has_success_marker, write_success_marker

log = logging.getLogger("reflexiv_tpu_torch")

# ordered stage names of the meta pipeline (cf. the 00firstFour ..
# 09ExtendAgain ladder, Pipelines.java:856-1290)
META_STAGES: Tuple[str, ...] = (
    "00sorted", "01reduced", "02extended", "03fixed", "04contigs",
)
BLOCK_ROWS = 1 << 20
BLOCK_LIMBS = 1 << 24   # rows x width of one block of a flat pool


def stage_dir(workdir: str, stage: str) -> str:
    return os.path.join(workdir, stage)


def _save_groups(d: str, groups, prefix: str) -> int:
    os.makedirs(d, exist_ok=True)
    for i, (seq, length, subk, left, right) in enumerate(groups):
        np.savez(os.path.join(d, f"{prefix}_{i:05d}.npz"), seq=seq,
                 length=length, subk=subk, left=left, right=right)
    return sum(len(g[1]) for g in groups)


def _load_groups(d: str, prefix: str):
    out = []
    for path in sorted(glob.glob(os.path.join(d, f"{prefix}_*.npz"))):
        z = np.load(path)
        out.append((z["seq"], z["length"], z["subk"], z["left"],
                    z["right"]))
    return out


def _write_pool_blocks(d: str, pool) -> int:
    """Write a byte or packed pool's live rows as packed blocks under ``d``
    (``checkpoint._write_pool_blocks``). Returns the rows written."""
    os.makedirs(d, exist_ok=True)
    packed_in = np.dtype(pool.seq.dtype) == np.uint32
    N = pool.seq.shape[0]
    base_cap = pool.seq.shape[1] * (16 if packed_in else 1)
    written = bi = 0
    for lo in range(0, N, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, N)
        live = np.asarray(pool.live[lo:hi])
        idx = np.nonzero(live)[0]
        if not len(idx):
            continue
        seq = np.asarray(pool.seq[lo:hi])[idx]
        length = np.asarray(pool.length[lo:hi])[idx]
        if not packed_in:
            col = np.arange(seq.shape[1])
            seq = pack_seq_matrix_np(
                np.where(col[None, :] < length[:, None], seq, 0))
        np.savez(os.path.join(d, f"block_{bi:05d}.npz"), seq=seq,
                 length=length, subk=np.asarray(pool.subk[lo:hi])[idx],
                 left=np.asarray(pool.left[lo:hi])[idx],
                 right=np.asarray(pool.right[lo:hi])[idx], live=live[idx])
        written += len(idx)
        bi += 1
    with open(os.path.join(d, "meta.json"), "w") as fh:
        json.dump({"format": "packed_v2", "rows": written,
                   "base_capacity": int(base_cap),
                   "limbs": int(limbs_for(base_cap))}, fh)
    return written


def _read_pool_blocks(d: str):
    """-> (packed (N, LW) uint32, length, subk, left, right, live,
    base_capacity)."""
    with open(os.path.join(d, "meta.json")) as fh:
        meta = json.load(fh)
    rows, lw = meta["rows"], meta["limbs"]
    seq = np.zeros((rows, lw), np.uint32)
    length = np.zeros(rows, np.int32)
    subk = np.ones(rows, np.int32)
    left = np.zeros(rows, np.int32)
    right = np.zeros(rows, np.int32)
    live = np.zeros(rows, bool)
    at = 0
    for path in sorted(glob.glob(os.path.join(d, "block_*.npz"))):
        z = np.load(path)
        n = len(z["length"])
        seq[at:at + n, :z["seq"].shape[1]] = z["seq"]
        length[at:at + n] = z["length"]
        subk[at:at + n] = z["subk"]
        left[at:at + n] = z["left"]
        right[at:at + n] = z["right"]
        live[at:at + n] = z["live"]
        at += n
    if at != rows:
        raise ValueError(f"checkpoint {d}: {at} rows read, meta says {rows}")
    return seq, length, subk, left, right, live, meta["base_capacity"]


def _flat_blocks(pool: "pd.FlatPool"):
    """``(seq, length, subk, left, right)`` numpy blocks of consecutive
    rows of a flat pool (on the host), each as wide as its longest row and
    within ``BLOCK_ROWS`` rows and ``BLOCK_LIMBS`` limbs."""
    pool = pool.to("cpu")
    nl = ((pool.length.to(torch.int64) + 15) // 16).numpy()

    def cut(lo, hi):
        w = max(int(nl[lo:hi].max()), 1)
        if hi - lo > 1 and (hi - lo > BLOCK_ROWS or
                            (hi - lo) * w > BLOCK_LIMBS):
            mid = (lo + hi) // 2
            yield from cut(lo, mid)
            yield from cut(mid, hi)
            return
        part = pd.take(pool, torch.arange(lo, hi))
        yield (pd.to_dense(part, w).numpy().astype(np.uint32),
               *(t.numpy() for t in part[1:]))

    for lo in range(0, pool.n, BLOCK_ROWS):
        yield from cut(lo, min(lo + BLOCK_ROWS, pool.n))


def _write_flat_blocks(d: str, pool: "pd.FlatPool", limbs: int = 1) -> int:
    """``pool`` as ``packed_v2`` blocks; ``meta.json`` gives the widest
    block's limbs, or ``limbs`` when that is more (the row width of the
    dense pool the JAX package would hold, which it reads back)."""
    os.makedirs(d, exist_ok=True)
    for bi, (seq, length, subk, left, right) in enumerate(_flat_blocks(pool)):
        np.savez(os.path.join(d, f"block_{bi:05d}.npz"), seq=seq,
                 length=length, subk=subk, left=left, right=right,
                 live=np.ones(len(length), bool))
        limbs = max(limbs, seq.shape[1])
    with open(os.path.join(d, "meta.json"), "w") as fh:
        json.dump({"format": "packed_v2", "rows": pool.n,
                   "base_capacity": 16 * limbs, "limbs": limbs}, fh)
    return pool.n


def _read_flat(d: str) -> "pd.FlatPool":
    """A ``packed_v2`` or ``groups_v1`` pool directory as a host flat pool,
    block by block (the widest row's dense matrix never exists)."""
    with open(os.path.join(d, "meta.json")) as fh:
        if json.load(fh).get("format") == "groups_v1":
            return pd.from_groups(_load_groups(d, "g"))
    parts = []
    for path in sorted(glob.glob(os.path.join(d, "block_*.npz"))):
        z = np.load(path)
        live = z["live"].astype(bool)
        parts.append(pd.from_dense(z["seq"][live], *(
            z[c][live] for c in ("length", "subk", "left", "right"))))
    return pd.cat(parts, "cpu")


def save_records(workdir: str, stage: str, recs) -> None:
    """Checkpoint a pool (byte :class:`DynRecords`, packed
    :class:`PackedDynRecords`, a :class:`packed_dyn.FlatPool` or a
    width-class group list)."""
    d = stage_dir(workdir, stage)
    if isinstance(recs, pd.FlatPool):
        if os.path.exists(d):
            shutil.rmtree(d)
        n = _write_flat_blocks(d, recs)
        write_success_marker(d)
        log.info("checkpoint: wrote stage %s (%d live rows)", stage, n)
        return
    if isinstance(recs, list):
        if os.path.exists(d):
            shutil.rmtree(d)
        n = _save_groups(d, recs, "g")
        with open(os.path.join(d, "meta.json"), "w") as fh:
            json.dump({"format": "groups_v1", "groups": len(recs),
                       "rows": n}, fh)
        write_success_marker(d)
        log.info("checkpoint: wrote stage %s (%d live rows, %d groups)",
                 stage, n, len(recs))
        return
    n = _write_pool_blocks(d, recs)
    write_success_marker(d)
    log.info("checkpoint: wrote stage %s (%d live rows)", stage, n)


def load_records(workdir: str, stage: str, flat: bool = False):
    """A stage snapshot as a host byte :class:`DynRecords`, or the group
    list a ``groups_v1`` stage holds; with ``flat`` as a host
    :class:`packed_dyn.FlatPool` of its live rows in order."""
    d = stage_dir(workdir, stage)
    if flat:
        return _read_flat(d)
    with open(os.path.join(d, "meta.json")) as fh:
        if json.load(fh).get("format") == "groups_v1":
            return _load_groups(d, "g")
    packed, length, subk, left, right, live, base_cap = _read_pool_blocks(d)
    N = len(length)
    seq = np.empty((N, base_cap), np.uint8)
    for lo in range(0, N, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, N)
        seq[lo:hi] = unpack_seq_matrix_np(packed[lo:hi], base_cap)
    return DynRecords(seq, length, subk, left, right, live)


def save_kset(workdir: str, name: str, triple, k: int) -> None:
    """One per-k (bases (n, k) uint8, left, right) set, bases packed."""
    bases, left, right = triple
    d = stage_dir(workdir, name)
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "set.npz"),
             seq=pack_seq_matrix_np(np.asarray(bases, np.uint8)),
             k=np.int32(k), left=np.asarray(left, np.int32),
             right=np.asarray(right, np.int32))
    write_success_marker(d)


def load_kset(workdir: str, name: str):
    z = np.load(os.path.join(stage_dir(workdir, name), "set.npz"))
    return unpack_seq_matrix_np(z["seq"], int(z["k"])), z["left"], z["right"]


def has_kset(workdir: str, name: str) -> bool:
    return has_success_marker(stage_dir(workdir, name))


def save_loop_state(ckpt_dir: str, pool, parked: list, state: dict,
                    limbs: int = 1) -> None:
    """Checkpoint the extension loop mid-flight into a fresh ``it_<n>``
    dir whose ``_SUCCESS`` lands last; older round dirs go only after it is
    complete, so a death mid-write leaves one valid resume point. A flat
    pool is written as at least ``limbs`` limbs wide."""
    it = state["it"]
    d = os.path.join(ckpt_dir, f"it_{it:05d}")
    if os.path.exists(d):
        shutil.rmtree(d)
    if isinstance(pool, list):
        _save_groups(os.path.join(d, "live"), pool, "g")
    elif isinstance(pool, pd.FlatPool):
        _write_flat_blocks(os.path.join(d, "pool"), pool, limbs)
    else:
        _write_pool_blocks(os.path.join(d, "pool"), pool)
    # a flat batch goes as consecutive blocks: the reader appends them in
    # order, so the parked rows come back as they were
    _save_groups(os.path.join(d, "parked"), [
        blk for b in parked for blk in (
            _flat_blocks(b) if isinstance(b, pd.FlatPool) else [b])], "p")
    with open(os.path.join(d, "state.json"), "w") as fh:
        json.dump(state, fh)
    write_success_marker(d)
    for other in glob.glob(os.path.join(ckpt_dir, "it_*")):
        if os.path.basename(other) != f"it_{it:05d}":
            shutil.rmtree(other, ignore_errors=True)
    log.info("checkpoint: extension loop state at round %d -> %s", it, d)


def load_loop_state(ckpt_dir: str, flat: bool = False):
    """Newest complete in-loop checkpoint as (pool, parked, state), or
    None; the pool is a group list or a host :class:`PackedDynRecords`,
    or with ``flat`` a host :class:`packed_dyn.FlatPool`, and then every
    parked batch is one too."""
    if not os.path.isdir(ckpt_dir):
        return None
    for d in sorted(glob.glob(os.path.join(ckpt_dir, "it_*")), reverse=True):
        if not has_success_marker(d):
            continue
        ldir = os.path.join(d, "live")
        if flat:
            pool = pd.from_groups(_load_groups(ldir, "g")) \
                if os.path.isdir(ldir) else _read_flat(os.path.join(d, "pool"))
        elif os.path.isdir(ldir):
            pool = _load_groups(ldir, "g")
        else:
            pool = PackedDynRecords(
                *_read_pool_blocks(os.path.join(d, "pool"))[:6])
        parked = _load_groups(os.path.join(d, "parked"), "p")
        if flat:
            parked = [pd.from_dense(*g) for g in parked]
        with open(os.path.join(d, "state.json")) as fh:
            state = json.load(fh)
        return pool, parked, state
    return None


def clear_partial(workdir: str, name: str) -> None:
    """Remove ``<name>`` and every ``<name>*`` partial namespace."""
    for d in glob.glob(os.path.join(workdir, name + "*")):
        shutil.rmtree(d, ignore_errors=True)


def save_contigs_attrs(workdir: str, stage: str, contigs) -> None:
    """Contigs with (left, right) attrs: ``left<TAB>right<TAB>seq`` lines."""
    d = stage_dir(workdir, stage)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "contigs.txt"), "w") as fh:
        for s, l, r in contigs:
            fh.write(f"{l}\t{r}\t{s}\n")
    write_success_marker(d)
    log.info("checkpoint: wrote stage %s", stage)


def load_contigs_attrs(workdir: str, stage: str):
    """Contigs back as (seq, left, right); attr-less lines read (0, 0)."""
    out = []
    with open(os.path.join(stage_dir(workdir, stage), "contigs.txt")) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if "\t" in line:
                l, r, s = line.split("\t", 2)
                out.append((s, int(l), int(r)))
            else:
                out.append((line, 0, 0))
    return out


def latest_stage(workdir: str,
                 stages: Tuple[str, ...] = META_STAGES) -> Optional[str]:
    """Newest stage with a ``_SUCCESS`` marker, scanning backwards."""
    for stage in reversed(stages):
        if has_success_marker(stage_dir(workdir, stage)):
            return stage
    return None


def clear_from(workdir: str, stage: str,
               stages: Tuple[str, ...] = META_STAGES) -> None:
    """Delete ``stage`` and every later stage, plus any partial dirs."""
    drop = False
    for s in stages:
        drop = drop or s == stage
        if drop and os.path.exists(stage_dir(workdir, s)):
            shutil.rmtree(stage_dir(workdir, s))
    for part in glob.glob(os.path.join(workdir, "*partial*")):
        shutil.rmtree(part, ignore_errors=True)
