"""Sharded single-k assembly over a device mesh (``reflexiv_tpu.parallel``).

A mesh is an ordered list of devices, repeats allowed: ``[cuda:0] * 4`` or
``[cpu] * 8`` is a mesh of virtual shards, as XLA's forced host device
count is for the JAX package. In a :class:`Mesh` one process drives every
shard, as the JAX package's ``shard_map`` over its local devices does. A
sharded value is a list with one tensor (or record set) per shard, each on
its shard's device.

A :class:`distributed.ProcessMesh` spreads the shards over processes (one
per card, or several local shards each), as ``jax.distributed`` does: the
functions below that the JAX package runs on global arrays (counting, the
fork passes, the packed round and census, the mercy table, the mixed-k
round) then take this process's block and return its local shards, and
the exchange runs over ``torch.distributed.all_to_all_single``. Both
meshes give the same rows shard for shard. The whole-run functions
(:func:`assemble_reads_sharded`, :func:`extension_loop_sharded`,
:func:`finished_mask_pdyn_sharded`, ``meta``'s mesh loop) read every
shard on one host and stay single-controller, as in the JAX package.

Rows move between shards by hash owner: :func:`bitpack.mix32` chained over
the JAX package's uint32 limbs of the row's key, salted per exchange,
modulo the shard count, so every row goes to the shard the JAX package
sends it to. The JAX exchange writes fixed-capacity buckets and reports
overflow (static shapes); here the n x n bucket sizes are read on the
host, one read per exchange, and each (source, destination) slice is
copied whole, so no row is ever dropped. The order is the JAX package's:
within a source, rows in stable order by owner; at a destination, sources
in mesh order (``all_to_all(..., tiled=True)``).

Counting (the extraction kernel and the radix sort on a CUDA shard), the
fork passes, the packed extension round and the census run per shard with
the single-card functions. A shard counts its reads before the exchange
and sends its unique (key, count) rows, in passes of one card's size, so
the owners' tables are the JAX package's and any input size counts.
Records stay on their shard between rounds;
each round's exchange keeps only the live rows, in order, which is the JAX
package's stable live-first compaction.

``meta`` takes a mesh too (``meta.assemble_dynamic(..., mesh=)``): stage 00
counts and fork-filters each k here (:func:`sort_k_records_sharded`, or
:func:`mercy_kmer_table_sharded` under ``-accurate``), and the mixed-k
rounds of stages 02, 03 and 05 run :func:`pdyn_extension_round_sharded`
on per-shard :class:`packed_dyn.FlatPool` pools, which
:func:`pad_pdyn` lays out as the JAX package's ``_pad_pdyn`` does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import metrics
from . import packed as pk
from . import packed_dyn as pd
from .assembler import extension_fixpoint
from .bitpack import (check_k, limbs_from_keys, mix32, pack_bases,
                      revcomp_bases, unpack_bases)
from .contigs import emit_contigs
from .count import (COUNT_MAX, _RunningTable, count_kmers, empty_table,
                    pass_rows)
from .device import resolve_device, synchronize
from .graph import _fork_pass
from .params import Params
from .records import Records, next_pow2

# owner salts of the JAX package's exchanges (reflexiv_tpu/parallel.py)
COUNT_SALT = 0x9E3779B9    # :108
PREFIX_SALT = 0xB5297A4D   # :532, fork pass 1
SUFFIX_SALT = 0x68E31DA4   # :540, fork pass 2
ROUND_SALT = 0x85EBCA6B    # :304
CENSUS_SALT = 0xC2B2AE35   # :622
DYN_ROUND_SALT = 0x27D4EB2F  # :376, the mixed-k round
DYN_CAP_FACTOR = 4           # the JAX mesh loop's bucket rows (dynamic.py:685)


class Mesh(NamedTuple):
    """One process over every shard. The sharded functions see a mesh
    through ``devices`` (the shards this process drives), ``size`` (all
    shards), ``first`` (the global index of ``devices[0]``) and the four
    methods below, which :class:`distributed.ProcessMesh` implements with
    collectives; here they are copies between this process's devices."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> int:
        return 0

    def tables_on(self, dev: torch.device) -> int:
        """Shards on ``dev``."""
        return self.devices.count(dev)

    def allgather_ints(self, values: Sequence[int]) -> List[List[int]]:
        return [list(values)]

    def size_table(self, rows: List[torch.Tensor]) -> List[List[int]]:
        """The ``size x size`` table of the per-shard rows, in one host
        read."""
        return torch.stack([r.to(self.devices[0]) for r in rows]).tolist()

    def exchange(self, parts: List[List[torch.Tensor]],
                 recv) -> List[List[torch.Tensor]]:
        """``out[d][s]`` is ``parts[s][d]`` on shard d's device."""
        return [[parts[s][d].to(dev, non_blocking=True)
                 for s in range(self.size)]
                for d, dev in enumerate(self.devices)]


def make_mesh(devices: Sequence) -> Mesh:
    """A mesh over ``devices`` in order, each checked by
    :func:`device.resolve_device` (``cuda`` without a card raises); a bare
    ``cuda`` means the current card."""
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs))


def _pad_rows(recs, cap: int, seq_cap: int):
    """The live rows of ``recs`` (:class:`Records` or packed records), in
    row order, placed first in a fresh set of ``cap`` rows whose ``seq``
    is ``seq_cap`` columns wide (``parallel._pad_rows``)."""
    idx = torch.nonzero(recs.live).squeeze(1)
    n = idx.numel()
    if n > cap:
        raise ValueError(f"{n} live rows exceed capacity {cap}")
    seq = recs.seq.new_zeros((cap, seq_cap))
    seq[:n, :recs.seq.shape[1]] = recs.seq[idx]

    def col(t):
        out = t.new_zeros(cap)
        out[:n] = t[idx]
        return out

    return type(recs)(seq, col(recs.length), col(recs.left),
                      col(recs.right), col(recs.live))


# ---------------------------------------------------------------------------
# owners and the exchange
# ---------------------------------------------------------------------------

def hash_owner(limbs: torch.Tensor, n: int, salt: int) -> torch.Tensor:
    """Owner shard of each ``(N, W)`` row of JAX-layout uint32 limbs:
    ``mix32`` of the first limb xor ``salt``, chained over the rest
    (``parallel._hash_owner``)."""
    h = mix32(limbs[:, 0] ^ salt)
    for i in range(1, limbs.shape[1]):
        h = mix32(h ^ limbs[:, i])
    return h % n


def _window_owner(bases: torch.Tensor, n: int, salt: int) -> torch.Tensor:
    """Owner of each ``(N, w)`` base window, hashed over the JAX package's
    right-aligned limbs of it (``bitpack.pack_bases``)."""
    w = bases.shape[1]
    return hash_owner(limbs_from_keys(pack_bases(bases, w), w), n, salt)


class Route(NamedTuple):
    """Where each local source's rows go: ``orders[s]`` is local shard s's
    rows in stable order by owner, and ``sizes[g][d]`` how many rows
    global shard g sends to global shard d (rows with owner ``size``, the
    dead ones, go nowhere); ``limbs[g][d]`` the flat pool limbs those rows
    hold, where the route was planned with ``row_limbs``."""
    orders: List[torch.Tensor]
    sizes: List[List[int]]
    limbs: Optional[List[List[int]]] = None


def plan_route(owners: List[torch.Tensor], mesh, row_limbs=None) -> Route:
    """Route rows by owner (``_bucketize``): the ``size x size`` bucket
    sizes (and, given each row's limb count ``row_limbs[s]``, the limb
    totals beside them) reach the host in one read, after one gather
    across the processes of a :class:`distributed.ProcessMesh`."""
    n = mesh.size
    orders = [torch.sort(o, stable=True).indices for o in owners]
    rows = [torch.bincount(o, minlength=n + 1)[:n] for o in owners]
    if row_limbs is None:
        return Route(orders, mesh.size_table(rows))
    rows = [torch.cat([r, torch.zeros(n + 1, dtype=torch.int64,
                                      device=o.device)
                       .index_add_(0, o, nl.to(torch.int64))[:n]])
            for r, o, nl in zip(rows, owners, row_limbs)]
    table = mesh.size_table(rows)
    return Route(orders, [r[:n] for r in table], [r[n:] for r in table])


def _recv_sizes(table: List[List[int]], mesh) -> List[List[int]]:
    """What each local shard receives from every global shard."""
    return [[row[mesh.first + j] for row in table]
            for j in range(len(mesh.devices))]


def _send_column(cols: List[torch.Tensor], mesh,
                 table: List[List[int]]) -> List[torch.Tensor]:
    """One row-aligned column of every local source, already in route
    order, split by ``table``: each local shard's received rows, sources
    in global mesh order."""
    parts = [t.split(table[mesh.first + s]) for s, t in enumerate(cols)]
    return [torch.cat(got) for got in
            mesh.exchange(parts, _recv_sizes(table, mesh))]


def send(route: Route, cols: List[tuple], mesh) -> List[tuple]:
    """Exchange row-aligned tensors (``cols[s]`` a tuple of local source
    s's columns) along ``route``; returns each local shard's received
    columns, sources in global mesh order (``_scatter_exchange``, exact
    sizes; the order of ``all_to_all(..., tiled=True)``)."""
    taken = []
    for s, cs in enumerate(cols):
        idx = route.orders[s][:sum(route.sizes[mesh.first + s])]
        taken.append([t[idx] for t in cs])
    got = [_send_column(list(c), mesh, route.sizes)
           for c in zip(*taken)]
    return [tuple(c[d] for c in got) for d in range(len(mesh.devices))]


def send_back(route: Route, vals: List[torch.Tensor], mesh,
              fill) -> List[torch.Tensor]:
    """The reverse exchange: ``vals[d]`` holds one value per row local
    shard d received; each returns to its source row, and rows that were
    not sent get ``fill``."""
    back_sizes = [list(r) for r in zip(*route.sizes)]
    parts = [v.split(back_sizes[mesh.first + d]) for d, v in enumerate(vals)]
    out = []
    for got, order, dev in zip(
            mesh.exchange(parts, _recv_sizes(back_sizes, mesh)),
            route.orders, mesh.devices):
        back = torch.cat(got)
        full = torch.full(order.shape, fill, dtype=back.dtype, device=dev)
        full[order[:back.shape[0]]] = back
        out.append(full)
    return out


# ---------------------------------------------------------------------------
# counting and the fork filter
# ---------------------------------------------------------------------------

def _block_passes(R: int, block: int, rows: int, shards: int
                  ) -> List[List[Tuple[int, int]]]:
    """Passes of ``rows`` rows over ``shards`` contiguous blocks of
    ``block`` rows of an ``R``-row matrix: pass i is one ``(lo, hi)`` row
    range per block, empty where a block has run out."""
    return [[(min(s * block + lo, R), min(s * block + lo + rows,
                                          (s + 1) * block, R))
             for s in range(shards)]
            for lo in range(0, block, rows)]


def shard_passes(bases, k: int, mesh, partitions: int = 0
                 ) -> List[List[Tuple[int, int]]]:
    """The counting passes over the ``R`` reads of ``L`` bases of
    ``bases``: each of the mesh's ``n`` shards takes a contiguous block of
    ``ceil(R / n)`` rows (the JAX package's ``P("shards")`` split, its
    zero-length padding rows left out), cut into passes of
    :func:`count.pass_rows` rows (so about ``partitions`` passes in all
    under ``-partition``). Pass i is one ``(lo, hi)`` row range per local
    shard, empty where a block has run out.

    On a :class:`distributed.ProcessMesh`, ``bases`` is this process's
    block, and every process learns the others' row counts and widths in
    one gather, so all of them make the same passes: each local shard
    takes ``B`` rows, ``B`` the most any process's block gives a shard
    (process p's block is rows ``[p * R_pad / P, (p + 1) * R_pad / P)`` of
    the matrix padded to ``R_pad`` rows, as ``multiprocess_smoke.py``
    feeds the JAX package's global arrays; its last block may be short or
    empty)."""
    R, L = bases.shape
    local = len(mesh.devices)
    info = mesh.allgather_ints([R, L])
    block = max(-(-r // local) for r, _ in info)
    rows = pass_rows(sum(r for r, _ in info), max(w for _, w in info), k,
                     partitions)
    return [[(min(s * block + lo, R), min(s * block + lo + rows,
                                          (s + 1) * block, R))
             for s in range(local)]
            for lo in range(0, block, rows)]


def count_kmers_sharded(bases, lengths, *, k: int, min_cov: int,
                        max_cov: int = 10_000_000, partitions: int = 0,
                        mesh, plain: bool = False
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Sharded canonical k-mer counting (``parallel.count_kmers_sharded``).
    In each pass of :func:`shard_passes` every shard counts its rows with
    :func:`count.count_kmers` (the extraction kernel and the radix sort on
    a card) into a unique ``(key, count)`` table, routes each row of it to
    its owner, and the owner merges what it receives into a running table
    (:class:`count._RunningTable`, which spills to host memory past its
    row limit); the coverage band applies once at the end. Returns one
    ``(keys, counts)`` table per shard, ascending, which is the table the
    JAX package's owner counts from every window it receives; every key
    lives on exactly one shard. Any number of reads counts, in passes of
    at most ``STREAM_WINDOW_LIMIT // W`` windows a shard (fewer under
    ``partitions``). ``plain`` runs the kernels' plain versions. Like the
    JAX function it takes no clips: the sharded ``run`` and ``meta``
    count every base of every read whatever ``-clipf``/``-clipe`` say.

    On a :class:`distributed.ProcessMesh`, ``bases`` is this process's
    block (:func:`shard_passes`), every process makes the same passes
    (an empty block joins each exchange with empty tables), and the
    result is the local shards' tables; ``count.table_rows_k<k>`` counts
    this process's shards."""
    check_k(k)
    n = mesh.size
    met = metrics.current()
    tables = [_RunningTable(k, dev, tables=mesh.tables_on(dev))
              for dev in mesh.devices]
    for ranges in shard_passes(bases, k, mesh, partitions):
        met.add("count.chunks")
        local = []
        for (lo, hi), dev in zip(ranges, mesh.devices):
            if hi > lo:
                local.append(count_kmers(
                    bases[lo:hi], lengths[lo:hi], k=k, min_cov=1,
                    max_cov=COUNT_MAX, device=dev, plain=plain))
            else:
                local.append(empty_table(k, dev))
        route = plan_route([hash_owner(limbs_from_keys(keys, k), n,
                                       COUNT_SALT) for keys, _ in local],
                           mesh)
        got = send(route, local, mesh)
        del local
        for d, (keys, counts) in enumerate(got):
            # source s's rows arrive sorted: merge them one source at a time
            sizes = [route.sizes[s][mesh.first + d] for s in range(n)]
            for kk, cc in zip(keys.split(sizes), counts.split(sizes)):
                tables[d].add(kk, cc)
        del got
    out, rows = [], 0
    for t in tables:             # each sets its rows before the band
        out.append(t.finish(min_cov, max_cov))
        rows += met.counts[f"count.table_rows_k{k}"]
    met.set(f"count.table_rows_k{k}", rows)
    return out


def build_initial_records_sharded(
    tables: List[Tuple[torch.Tensor, torch.Tensor]], *, k: int,
    min_error: int, mesh, bubble: bool = True,
) -> List[Records]:
    """Sharded RC expansion and both fork passes
    (``parallel.build_initial_records_sharded``): pass 1 routes the
    two-strand rows to the owner of their (k-1)-base prefix, pass 2 the
    winners to the owner of their suffix with the right attr riding along.
    Returns each shard's fork-filtered records, all live, in pass-2 order
    (``compact_records_sharded``). ``bubble=False`` skips both passes and
    every row stays on its shard."""
    sub = k - 1
    n = mesh.size
    rows = []
    for keys, counts in tables:
        fwd = unpack_bases(keys, k)
        cover = counts.to(torch.int32)
        rows.append((torch.cat([fwd, revcomp_bases(fwd)]),
                     torch.cat([cover, cover])))

    def all_live(t):
        return torch.ones(t.shape[0], dtype=torch.bool, device=t.device)

    def full_k(t):
        return torch.full((t.shape[0],), k, dtype=torch.int32,
                          device=t.device)

    if not bubble:
        return [Records(b, full_k(b), c, c.clone(), all_live(b))
                for b, c in rows]
    owners = [_window_owner(b[:, :sub], n, PREFIX_SALT) for b, _ in rows]
    got = send(plan_route(owners, mesh), rows, mesh)
    pass1, owners = [], []
    for b, c in got:
        b1, c1, win1, right1, _ = _fork_pass(
            b, c, all_live(b), lo=0, hi=sub, ext_col=k - 1,
            min_error=min_error, blocked=sub)
        pass1.append((b1, c1, right1))
        owners.append(torch.where(
            win1, _window_owner(b1[:, 1:k], n, SUFFIX_SALT), n))
    got = send(plan_route(owners, mesh), pass1, mesh)
    out = []
    for b, c, right in got:
        b2, _c2, win2, left2, right2 = _fork_pass(
            b, c, all_live(b), lo=1, hi=k, ext_col=0,
            min_error=min_error, blocked=sub, carry=right)
        b2 = b2[win2]
        out.append(Records(b2, full_k(b2), left2[win2], right2[win2],
                           all_live(b2)))
    return out


def _as_shard(x, dtype, dev) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    return t.to(dev, dtype)


def sort_k_records_sharded(bases, lengths, k: int, params: Params, *,
                           mesh: Mesh, plain: bool = False):
    """Stage 00 of ``meta`` for one k on a mesh (``dynamic
    .sort_k_records_sharded``): :func:`count_kmers_sharded` (no clips) and
    :func:`build_initial_records_sharded`, then every shard's records in
    shard order, as host ``(bases (M, k) uint8, left, right)``."""
    tables = count_kmers_sharded(
        bases, lengths, k=k, min_cov=params.min_kmer_coverage,
        max_cov=params.max_kmer_coverage, mesh=mesh, plain=plain)
    recs = build_initial_records_sharded(
        tables, k=k, min_error=params.min_error_for_k(k), mesh=mesh,
        bubble=params.bubble)
    return tuple(np.concatenate([c.cpu().numpy() for c in col])
                 for col in zip(*((r.seq[:, :k].to(torch.uint8), r.left,
                                   r.right) for r in recs)))


def mercy_kmer_table_sharded(bases, lengths, *, k: int, min_cov: int,
                             max_cov: int = 10_000_000, mesh,
                             plain: bool = False):
    """Solid + mercy table with the count table hash-sharded
    (``parallel.mercy_kmer_table_sharded`` and ``_mercy_flags_sharded``):
    a ``min_cov = 1`` table per shard (:func:`count_kmers_sharded`); each
    shard cuts its reads' windows with the extraction kernel and sends
    each to the shard owning its key, which looks its count up and sends
    it back; the flank rule runs on the reads' own shard
    (:func:`mercy.flank_rule`); every mercy key goes to its owner, which
    flags that table row. On a :class:`Mesh` returns ``(keys, counts)``
    on the first shard's device: each shard's solid and flagged rows,
    shards in order. On a :class:`distributed.ProcessMesh` (``bases`` this
    process's block) returns a list of each local shard's solid and
    flagged ``(keys, counts)``, local shards in order. The windows go in
    the passes of :func:`shard_passes`."""
    from .mercy import flank_rule, lookup_counts, window_keys

    n = mesh.size
    tables = count_kmers_sharded(bases, lengths, k=k, min_cov=1,
                                 max_cov=max_cov, mesh=mesh, plain=plain)
    flags = [torch.zeros(c.numel(), dtype=torch.bool, device=c.device)
             for _, c in tables]
    for ranges in shard_passes(bases, k, mesh):
        keys, valid, owners = [], [], []
        for (lo, hi), dev in zip(ranges, mesh.devices):
            kk, ok = window_keys(
                _as_shard(bases[lo:hi], torch.uint8, dev),
                _as_shard(lengths[lo:hi], torch.int32, dev), k=k,
                plain=plain)
            keys.append(kk)
            valid.append(ok)
            owners.append(torch.where(
                ok, hash_owner(limbs_from_keys(kk, k), n, COUNT_SALT), n))
        route = plan_route(owners, mesh)
        found = [lookup_counts(tk, tc, q)[0] for (q,), (tk, tc) in
                 zip(send(route, [(kk,) for kk in keys], mesh), tables)]
        counts = send_back(route, found, mesh, fill=0)
        mercy = [torch.where(flank_rule(c, ok, hi - lo, min_cov), o, n)
                 for c, ok, o, (lo, hi) in zip(counts, valid, owners,
                                               ranges)]
        got = send(plan_route(mercy, mesh), [(kk,) for kk in keys], mesh)
        for (q,), (tk, _tc), fl in zip(got, tables, flags):
            hit, pos = lookup_counts(tk, torch.ones_like(_tc), q)
            fl[pos[hit > 0]] = True
    out = [(tk[(tc >= min_cov) | fl], tc[(tc >= min_cov) | fl])
           for (tk, tc), fl in zip(tables, flags)]
    if not isinstance(mesh, Mesh):
        return out
    dev = mesh.devices[0]
    return (torch.cat([kk.to(dev) for kk, _ in out]),
            torch.cat([cc.to(dev) for _, cc in out]))


# ---------------------------------------------------------------------------
# extension rounds and the census
# ---------------------------------------------------------------------------

def extension_round_sharded_packed(
    pools: List[pk.PackedRecords], round_seed: int, *, k: int, mesh,
) -> List[pk.PackedRecords]:
    """One sharded round (``parallel.extension_round_sharded_packed``):
    each live row draws its orientation and goes to the owner of its
    marker-end (k-1)-base key; the owner runs
    :func:`packed.extension_round_packed` on what it received. Every
    shard's pool must have the same limb width."""
    n = mesh.size
    sub = k - 1
    owners = []
    for p in pools:
        marker = pk.draw_markers_packed(p, round_seed)
        start = torch.where(marker == 1, 0, p.length - sub).clamp(min=0)
        win = pk.extract_window(p.seq, start, sub)
        owners.append(torch.where(p.live, hash_owner(win, n, ROUND_SALT), n))
    got = send(plan_route(owners, mesh),
               [(p.seq, p.length, p.left, p.right) for p in pools], mesh)
    out = []
    for seq, length, left, right in got:
        live = torch.ones(length.shape[0], dtype=torch.bool,
                          device=length.device)
        joined, _live_n, _need = pk.extension_round_packed(
            pk.PackedRecords(seq, length, left, right, live), round_seed,
            k=k)
        out.append(joined)
    return out


def finished_mask_sharded(pools: List[pk.PackedRecords], *, k: int,
                          mesh) -> List[torch.Tensor]:
    """The mesh-wide census (``parallel.finished_mask_sharded``): every
    live row sends its head and tail (k-1)-base keys to their owners, the
    owner finds which messages have a live partner of the other end
    (:func:`packed.partnered_ends`), and the verdicts return to their
    rows. Per shard, the live rows with no partner at either end; equal to
    :func:`packed.finished_mask_packed` over the whole pool."""
    n = mesh.size
    sub = k - 1
    msgs, owners = [], []
    for p in pools:
        wins = torch.cat([
            pk.extract_window(p.seq, torch.zeros_like(p.length), sub),
            pk.extract_window(p.seq, (p.length - sub).clamp(min=0), sub)])
        live2 = torch.cat([p.live, p.live])
        msgs.append((pk.keys_from_windows(wins, live2, sub),
                     torch.cat([torch.zeros_like(p.live),
                                torch.ones_like(p.live)])))
        owners.append(torch.where(live2, hash_owner(wins, n, CENSUS_SALT), n))
    route = plan_route(owners, mesh)
    verdicts = [pk.partnered_ends(keys, is_tail, torch.ones_like(is_tail))
                for keys, is_tail in send(route, msgs, mesh)]
    back = send_back(route, verdicts, mesh, fill=True)
    return [p.live & ~b[:p.capacity] & ~b[p.capacity:]
            for p, b in zip(pools, back)]


def pad_pdyn(pools: List[pd.FlatPool], cap: int, mesh
             ) -> List[pd.FlatPool]:
    """Lay the rows of ``pools`` (in order) out as ``dynamic._pad_pdyn``
    and ``P("shards")`` do: into a pool of ``cap`` rows split into
    contiguous blocks of ``cap / n``, so shard s holds rows
    ``[s * cap / n, (s + 1) * cap / n)`` of the whole, and only its live
    rows are kept. Returns the shards of ``mesh.devices`` (on a
    :class:`distributed.ProcessMesh`, this process's, from the whole
    pool every process holds)."""
    n = mesh.size
    M = cap // n
    sizes = [p.n for p in pools]
    total = sum(sizes)
    if total > cap:
        raise ValueError(f"{total} live rows exceed capacity {cap}")
    pieces = [[] for _ in range(n)]
    g = 0
    for p, size in zip(pools, sizes):
        cuts = [min(max(t * M - g, 0), size) for t in range(n + 1)]
        for t, part in enumerate(pd.split(p, [b - a for a, b in
                                              zip(cuts, cuts[1:])])):
            pieces[t].append(part)
        g += size
    return [pd.cat(pieces[mesh.first + i], dev)
            for i, dev in enumerate(mesh.devices)]


def send_pools(route: Route, pools: List[pd.FlatPool], mesh
               ) -> List[pd.FlatPool]:
    """:func:`send` for flat pools (``route`` planned with each row's limb
    count): each source's rows in route order, cut per destination; each
    destination takes the sources in global mesh order. The limbs split
    by the route's limb totals, the other columns by its row counts."""
    parts = [pd.take(p, route.orders[s][:sum(route.sizes[mesh.first + s])])
             for s, p in enumerate(pools)]
    cols = [_send_column([p.limbs for p in parts], mesh, route.limbs)]
    cols += [_send_column(list(c), mesh, route.sizes)
             for c in zip(*(p[1:] for p in parts))]
    return [pd.FlatPool(*c) for c in zip(*cols)]


def pdyn_extension_round_sharded(
    pools: List[pd.FlatPool], round_seed: int, *, kmin: int, max_sub: int,
    mesh, cap: int, unique_only: bool = False,
) -> Optional[List[pd.FlatPool]]:
    """One sharded mixed-k round (``parallel.pdyn_extension_round_sharded``):
    each row goes to the owner of its (kmin-1)-base group key (``mix32``
    chained over the key's limbs, salt ``0x27D4EB2F``), and the owner runs
    :func:`packed_dyn.pdyn_extension_round_fused` on what it received;
    each shard keeps its joined rows in order. Returns None where the JAX
    round would overflow on a pool of ``cap`` rows (a source sends more
    than ``max(1, DYN_CAP_FACTOR * M // n)`` rows to one shard, or a shard
    ends with more than ``M = cap / n`` rows): the caller then re-lays at
    twice the capacity, as the JAX loop does. No row is ever dropped. On a
    :class:`distributed.ProcessMesh` both decisions are global (the
    route's table, and one gather of every process's largest shard), so
    every process returns None together."""
    n = mesh.size
    M = cap // n
    owners = [hash_owner(pd.group_keys(p, round_seed, kmin)[1], n,
                         DYN_ROUND_SALT) for p in pools]
    route = plan_route(owners, mesh,
                       row_limbs=[pd.row_offsets(p.length)[1] for p in pools])
    if max(max(row) for row in route.sizes) > max(1, DYN_CAP_FACTOR * M // n):
        return None
    out = [pd.pdyn_extension_round_fused(
        p, round_seed, kmin=kmin, max_sub=max_sub,
        unique_only=unique_only)[0]
        for p in send_pools(route, pools, mesh)]
    most = max(max(r) for r in mesh.allgather_ints([max(p.n for p in out)]))
    return None if most > M else out


def finished_mask_pdyn_sharded(pools: List[pd.FlatPool], max_sub: int,
                               mesh: Mesh) -> List[torch.Tensor]:
    """The mesh loop's census (``finished_mask_pdyn_exact`` over the whole
    pool): every shard's head and tail windows gathered on the first
    shard's device, :func:`packed_dyn.finished_mask` over them, and each
    shard's part of the mask back on its device."""
    dev = mesh.devices[0]
    if not sum(p.n for p in pools):
        return [torch.zeros(0, dtype=torch.bool, device=p.length.device)
                for p in pools]
    summ = [pd.summaries(p, max_sub) for p in pools]
    fin = pd.finished_mask(
        torch.cat([h.to(dev) for h, _ in summ]),
        torch.cat([t.to(dev) for _, t in summ]),
        torch.cat([p.subk.to(dev) for p in pools]), max_sub)
    return [f.to(p.length.device) for f, p in
            zip(fin.split([p.n for p in pools]), pools)]


# ---------------------------------------------------------------------------
# the sharded assembly
# ---------------------------------------------------------------------------

def _lap(name: str, mesh: Mesh) -> None:
    for dev in set(mesh.devices):
        synchronize(dev)
    metrics.current().lap(name)


def _live_and_need(pools: List[pk.PackedRecords], mesh: Mesh, sub: int):
    """Mesh-wide live count and the bases the next round's longest merge
    may need (the two longest live rows, less the overlap), in one host
    read."""
    stats = []
    for p in pools:
        lens = torch.where(p.live, p.length, 0).to(torch.int64)
        top = torch.topk(lens, min(2, lens.numel())).values
        stats.append(torch.cat([p.live.sum().view(1),
                                F.pad(top, (0, 2 - top.numel()))])
                     .to(mesh.devices[0]))
    stats = torch.stack(stats).tolist()
    tops = sorted((x for row in stats for x in row[1:]), reverse=True)
    return sum(row[0] for row in stats), tops[0] + tops[1] - sub


class MeshPool(NamedTuple):
    """Per-shard pools as one pool of :func:`assembler.extension_fixpoint`:
    ``live`` is the shards' masks, ``capacity`` the JAX package's pool rows
    over the mesh (the parking threshold)."""
    pools: List[pk.PackedRecords]
    capacity: int

    @property
    def live(self) -> List[torch.Tensor]:
        return [p.live for p in self.pools]


def extension_loop_sharded(pools: List[pk.PackedRecords], params: Params,
                           *, mesh: Mesh, seed: int, capacity: int) -> list:
    """The loop of ``parallel.assemble_reads_sharded``:
    :func:`assembler.extension_fixpoint` over :class:`MeshPool`, each round
    sharded, growing every shard before a round whose longest merge may not
    fit, the census mesh-wide. Parking clears ``live`` in place; no row
    moves between shards, and nothing compacts. Counts
    ``sharded/extension_rounds``. Returns the pools, then the parked
    batches, in the JAX package's merge order."""
    k = params.k
    need = k + 1           # two k-mers merge into k + 1 bases

    def step(mp, it, _live_n):
        nonlocal need
        pools = mp.pools
        if need > pools[0].base_capacity:
            pools = [pk.grow_packed(p, next_pow2(need)) for p in pools]
        pools = extension_round_sharded_packed(pools, seed + it, k=k,
                                               mesh=mesh)
        live_n, need = _live_and_need(pools, mesh, k - 1)
        return mp._replace(pools=pools), live_n

    def park(mp, fin, parked):
        return mp._replace(pools=[pk.park_finished_rows(p, f, parked)
                                  for p, f in zip(mp.pools, fin)])

    groups, it = extension_fixpoint(
        MeshPool(pools, capacity), step,
        lambda mp: finished_mask_sharded(mp.pools, k=k, mesh=mesh), park,
        params)
    metrics.current().set("sharded/extension_rounds", it)
    return groups[0].pools + groups[1:]


def assemble_reads_sharded(bases, lengths, params: Params, *, mesh: Mesh,
                           seed: int = 0, plain: bool = False
                           ) -> List[Tuple[str, str]]:
    """Single-k assembly with counting, the fork filter and the extension
    rounds sharded over ``mesh`` (``parallel.assemble_reads_sharded``);
    only bucket sizes, live counts and the contigs reach the host. As in
    the JAX package, ``-clipf``/``-clipe`` do not apply here; the count
    streams in passes past ``STREAM_WINDOW_LIMIT // W`` windows a shard or
    under ``-partition`` (:func:`count_kmers_sharded`). ``plain`` counts
    through the kernels' plain versions."""
    params.validate()
    met = metrics.current()
    tables = count_kmers_sharded(
        bases, lengths, k=params.k, min_cov=params.min_kmer_coverage,
        max_cov=params.max_kmer_coverage, partitions=params.partitions,
        mesh=mesh, plain=plain)
    met.set("sharded/solid_kmers", sum(c.numel() for _, c in tables))
    _lap("sharded/counting", mesh)
    recs = build_initial_records_sharded(
        tables, k=params.k, min_error=params.min_error_coverage, mesh=mesh,
        bubble=params.bubble)
    del tables
    shard_live = [r.capacity for r in recs]
    met.set("sharded/fork_filtered_records", sum(shard_live))
    _lap("sharded/graph", mesh)
    per_shard = max(next_pow2(max(shard_live) or 1) * 2, 16)
    groups = extension_loop_sharded(
        [pk.from_records(r) for r in recs], params, mesh=mesh, seed=seed,
        capacity=per_shard * mesh.size)
    _lap("sharded/extension", mesh)
    contigs = emit_contigs(groups, min_contig=params.min_contig)
    _lap("sharded/emit", mesh)
    met.set("sharded/contigs", len(contigs))
    return contigs
