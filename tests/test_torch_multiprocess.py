"""Parity of the port's process mesh (``reflexiv_tpu_torch.distributed``):
two gloo processes of 4 CPU shards each, every exchange crossing the
process boundary, against the single-controller port on
``make_mesh(["cpu"] * 8)`` and the JAX package on the 8 virtual CPU
devices of ``tests/conftest.py``. Exact throughout, shard for shard.

One job of two processes (this file run as a script, through a
``file://`` store under ``tmp_path``) makes every check's rows and writes
them to one ``.npz`` a process; each test compares one of them. Each
child has its own timeout, so a hang fails the job and cannot stall the
suite. The JAX imports live in the ``jx`` fixture, so the ``cuda`` tests
import no jax and run on a card with ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_multiprocess.py``."""
import torch_threads
import argparse
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from reflexiv_tpu_torch import meta, parallel  # noqa: E402
from reflexiv_tpu_torch import packed as pk  # noqa: E402
from reflexiv_tpu_torch import packed_dyn as pd  # noqa: E402
from reflexiv_tpu_torch.bitpack import limbs_from_keys  # noqa: E402
from reflexiv_tpu_torch.count import count_kmers  # noqa: E402
from reflexiv_tpu_torch.distributed import init_process_mesh  # noqa: E402
from reflexiv_tpu_torch.dyn_pool import unpack_seq_matrix_np  # noqa: E402
from reflexiv_tpu_torch.dynamic import sort_k_records  # noqa: E402
from reflexiv_tpu_torch.io import reads_to_matrix  # noqa: E402
from reflexiv_tpu_torch.multiprocess_smoke import (  # noqa: E402
    block, run_children, slice_outputs)
from reflexiv_tpu_torch.params import Params  # noqa: E402
from reflexiv_tpu_torch.records import Records  # noqa: E402

N, PROCS, LOCAL = 8, 2, 4
MESH = parallel.make_mesh(["cpu"] * N)
KLIST = (21, 31, 41)
MIN_ERROR = 8
CHILD_TIMEOUT = 240


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _reads(seed, genome_len, n_reads, read_len, genomes=1):
    """Exact substrings of ``genomes`` random genomes of ``genome_len``,
    ``genome_len / 3``, ... bases, half reverse-complemented."""
    rng = random.Random(seed)
    seqs = ["".join(rng.choice("ACGT") for _ in range(genome_len // (g + 1)))
            for g in range(genomes)]
    reads = []
    for i in range(n_reads):
        genome = seqs[i % genomes]
        s = rng.randrange(len(genome) - read_len)
        r = genome[s:s + read_len]
        reads.append(_revcomp(r) if rng.random() < 0.5 else r)
    return reads_to_matrix([r.encode() for r in reads])


def count_input():
    """90 bp reads (k = 61 fits) of two genomes, 301 of them: the last
    block is short, and the shorter genome's contig is finished while the
    longer one's still joins."""
    return _reads(5, 900, 301, 90, genomes=2)


def gap_input():
    """``test_parallel.py``'s gap genome: a single read spans a starved
    30 bp stretch, so mercy k-mers exist."""
    rng = random.Random(31)
    genome = "".join(rng.choice("ACGT") for _ in range(1500))
    lo, hi = 700, 730
    reads = [genome[s:s + 100] for s in range(0, len(genome) - 100, 20)
             if not (s + 100 > lo and s < hi)]
    for off in (0, 3, 6, 9):
        reads.append(genome[lo - 100 - off: lo - off])
        reads.append(genome[hi + off: hi + off + 100])
    reads.append(genome[lo - 35: hi + 35])
    return reads_to_matrix([r.encode() for r in reads])


def tiny_input():
    """Fewer reads than shards: process 1's block is all padding."""
    return _reads(9, 120, 3, 60)


def stage0_flat():
    """A stage 00 pool at KLIST on one card, its live rows as a flat pool,
    and its JAX-layout dense columns."""
    mat, lens = _reads(2, 600, 300, 70)
    params = Params(klist=KLIST, min_kmer_coverage=2)
    sets = []
    for k in KLIST:
        keys, counts = count_kmers(mat, lens, k=k, min_cov=2, device="cpu")
        sets.append((*sort_k_records(keys, counts, k, params), k))
    pool = meta.records_from_sorted(sets)
    live = np.asarray(pool.live)
    return pd.from_dense(np.asarray(pool.seq)[live],
                         *(np.asarray(a)[live] for a in pool[1:5])), pool


def random_flat(n_rows=420, k=31, seed=3):
    """Random k-base rows (``subk`` k - 1): no two share a group key, so a
    round joins nothing and each shard keeps what it receives."""
    codes = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 4, (n_rows, k), dtype=np.uint8))
    length = torch.full((n_rows,), k, dtype=torch.int32)
    return pd.from_dense(pk.pack_seq_matrix(codes), length,
                         torch.full_like(length, k - 1),
                         torch.full_like(length, -1),
                         torch.full_like(length, -1))


def round_sizes(fp, cap, k=31):
    """For ``pdyn_extension_round_sharded(..., cap)`` at round 1 on
    ``pad_pdyn([fp], cap)``: the route's largest bucket, the bucket limit
    and each shard's rows after the round (the function's own steps on
    the single-controller mesh, without its two decisions)."""
    shards = parallel.pad_pdyn([fp], cap, MESH)
    owners = [parallel.hash_owner(pd.group_keys(p, 1, k)[1], N,
                                  parallel.DYN_ROUND_SALT) for p in shards]
    route = parallel.plan_route(
        owners, MESH, row_limbs=[pd.row_offsets(p.length)[1]
                                 for p in shards])
    out = [pd.pdyn_extension_round_fused(p, 1, kmin=k, max_sub=k - 1)[0].n
           for p in parallel.send_pools(route, shards, MESH)]
    limit = max(1, parallel.DYN_CAP_FACTOR * (cap // N) // N)
    return max(max(r) for r in route.sizes), limit, out


def overflow_cap(fp):
    """The smallest cap (a multiple of N, room for every row) at which the
    round's bucket limit holds but a shard ends with more than cap / N
    rows, and every such shard belongs to one process: only the gather of
    each process's largest shard tells the other process to return None."""
    cap = -(-fp.n // N) * N
    while True:
        most, limit, sizes = round_sizes(fp, cap)
        over = {s // LOCAL for s, n in enumerate(sizes) if n > cap // N}
        if not over:
            raise ValueError("no capacity overflows on one process alone")
        if most <= limit and len(over) == 1:
            return cap, sizes
        cap += N


def rounds_then_census(seq, left, right, mesh, rounds=20, k=31):
    """The fork records (per local shard) in equal rows of 1024 bases,
    ``rounds`` sharded rounds, then the census over the rounds' pools laid
    out in equal rows: (pools, mask) per local shard."""
    from reflexiv_tpu_torch.multiprocess_smoke import most

    recs = [Records(torch.as_tensor(s), torch.full((len(s),), k,
                                                   dtype=torch.int32),
                    torch.as_tensor(lf), torch.as_tensor(rt),
                    torch.ones(len(s), dtype=torch.bool))
            for s, lf, rt in zip(seq, left, right)]
    rows = max(2 * most(mesh, [r.capacity for r in recs]), 16)
    pools = [pk.from_records(parallel._pad_rows(r, rows, 1024))
             for r in recs]
    for it in range(1, rounds + 1):
        pools = parallel.extension_round_sharded_packed(pools, it, k=k,
                                                        mesh=mesh)
    rows = most(mesh, [p.capacity for p in pools])
    pools = [parallel._pad_rows(p, rows, p.limb_capacity) for p in pools]
    return pools, parallel.finished_mask_sharded(pools, k=k, mesh=mesh)


# ---------------------------------------------------------------------------
# the job: one process of the 2 x 4 mesh
# ---------------------------------------------------------------------------

def job(rank, init, out_dir):
    mesh = init_process_mesh(backend="gloo", init_method=init,
                             world_size=PROCS, rank=rank,
                             local_devices=["cpu"] * LOCAL,
                             timeout_s=CHILD_TIMEOUT)
    res = {"tables_on": np.array(mesh.tables_on(mesh.devices[0]))}

    def keep(name, tensors):
        for i, t in enumerate(tensors):
            res[f"{name}/{mesh.first + i}"] = t.numpy()

    def local_block(mat_lens):
        return [block(a, rank, PROCS, N) for a in mat_lens]

    # the exchange alone: 2-D, bool and int32 columns, uneven sizes
    cols, owners = [], []
    for i in range(LOCAL):
        g = mesh.first + i
        rng = np.random.default_rng(g)
        n = 5 + 7 * g
        owners.append(torch.from_numpy(rng.integers(0, N + 1, n)))
        cols.append((torch.arange(n).view(-1, 1) * 10 + g
                     * torch.ones(1, 3, dtype=torch.int64),
                     torch.from_numpy(rng.random(n) < 0.5),
                     torch.full((n,), g, dtype=torch.int32)))
    route = parallel.plan_route(owners, mesh)
    for c, name in enumerate(("rows", "flags", "source")):
        keep(f"exchange.{name}", [got[c] for got in
                                  parallel.send(route, cols, mesh)])
    keep("exchange.back", parallel.send_back(
        route, [got[0][:, 0] for got in parallel.send(route, cols, mesh)],
        mesh, fill=-7))

    b, ln = local_block(count_input())
    sl = slice_outputs(b, ln, k=31, min_cov=2, min_error=MIN_ERROR,
                       mesh=mesh)
    for name, ts in sl.items():
        keep(f"k31.{name}", ts)
    pools, mask = rounds_then_census(sl["fork.seq"], sl["fork.left"],
                                     sl["fork.right"], mesh)
    for name, col in zip(pk.PackedRecords._fields, zip(*pools)):
        keep(f"rounds.{name}", col)
    keep("rounds.census", mask)
    tables = parallel.count_kmers_sharded(b, ln, k=61, min_cov=2, mesh=mesh)
    keep("k61.count.keys", [t for t, _ in tables])
    keep("k61.count.counts", [c for _, c in tables])

    b, ln = local_block(gap_input())
    out = parallel.mercy_kmer_table_sharded(b, ln, k=21, min_cov=3,
                                            mesh=mesh)
    keep("mercy.keys", [t for t, _ in out])
    keep("mercy.counts", [c for _, c in out])

    fp, _ = stage0_flat()
    cap = meta._mesh_capacity(fp.n, N)
    shards = parallel.pad_pdyn([fp], cap, mesh)
    for it in (1, 2):
        shards = parallel.pdyn_extension_round_sharded(
            shards, it, kmin=KLIST[0], max_sub=KLIST[-1] - 1, mesh=mesh,
            cap=cap)
        for name, col in zip(pd.FlatPool._fields, zip(*shards)):
            keep(f"dyn{it}.{name}", col)
    fp = random_flat()
    small, _sizes = overflow_cap(fp)
    got = parallel.pdyn_extension_round_sharded(
        parallel.pad_pdyn([fp], small, mesh), 1, kmin=31, max_sub=30,
        mesh=mesh, cap=small)
    res["overflow.none"] = np.array(got is None)

    b, ln = local_block(tiny_input())
    res["tiny.rows"] = np.array(b.shape[0])
    res["tiny.live_reads"] = np.array(int((ln > 0).sum()))
    tables = parallel.count_kmers_sharded(b, ln, k=21, min_cov=1, mesh=mesh)
    keep("tiny.count.keys", [t for t, _ in tables])
    recs = parallel.build_initial_records_sharded(
        tables, k=21, min_error=MIN_ERROR, mesh=mesh)
    keep("tiny.fork.seq", [r.seq for r in recs])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    mesh.close()


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    """Every check's rows from the 2 x 4 process mesh, by name, as a list
    over the 8 global shards (or one value a process)."""
    tmp = tmp_path_factory.mktemp("procmesh")
    init = "file://" + str(tmp / "store")
    run_children([[sys.executable, os.path.abspath(__file__), "--rank",
                   str(r), "--init", init, "--out", str(tmp)]
                  for r in range(PROCS)], timeout_s=CHILD_TIMEOUT,
                 env=_env())
    merged = {}
    for r in range(PROCS):
        with np.load(tmp / f"rank{r}.npz") as z:
            for key in z.files:
                name, _, g = key.partition("/")
                if g:
                    merged.setdefault(name, [None] * N)[int(g)] = z[key]
                else:
                    merged.setdefault(name, []).append(z[key])
    return merged


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from reflexiv_tpu import dynamic as jdyn
    from reflexiv_tpu import packed as jpk
    from reflexiv_tpu import packed_dyn as jpd
    from reflexiv_tpu import parallel as jpar

    assert len(jax.devices()) >= N, "tests/conftest.py sets 8 CPU devices"
    return types.SimpleNamespace(
        jnp=jnp, par=jpar, pk=jpk, pd=jpd, dyn=jdyn,
        mesh=jpar.make_mesh(jax.devices()[:N]))


@pytest.fixture(scope="module")
def single():
    """The same checks on the single-controller mesh."""
    out = {f"k31.{name}": ts for name, ts in slice_outputs(
        *count_input(), k=31, min_cov=2, min_error=MIN_ERROR,
        mesh=MESH).items()}
    tables = parallel.count_kmers_sharded(*count_input(), k=61, min_cov=2,
                                          mesh=MESH)
    out["k61.count.keys"] = [t for t, _ in tables]
    out["k61.count.counts"] = [c for _, c in tables]
    return out


def _per_shard(x):
    x = np.asarray(x)
    return x.reshape((N, -1) + x.shape[1:])


def _padded(mat, lens):
    R = -(-mat.shape[0] // N) * N
    bases = np.zeros((R, mat.shape[1]), np.uint8)
    bases[:mat.shape[0]] = mat
    ln = np.zeros(R, np.int32)
    ln[:mat.shape[0]] = lens
    return bases, ln


def _jax_tables(jx, mat, lens, k, min_cov):
    bases, ln = _padded(mat, lens)
    limbs, counts, keep, ovf = jx.par.count_kmers_sharded(
        jx.jnp.asarray(bases), jx.jnp.asarray(ln), k=k, min_cov=min_cov,
        mesh=jx.mesh)
    assert int(np.asarray(ovf).sum()) == 0
    return limbs, counts, keep


def _equal_lists(a, b):
    assert len(a) == len(b)
    for s, (x, y) in enumerate(zip(a, b)):
        y = y.numpy() if torch.is_tensor(y) else y
        assert x.shape == y.shape and x.dtype == y.dtype, s
        np.testing.assert_array_equal(x, y, err_msg=f"shard {s}")


def test_exchange_order_matches_single_controller(got):
    """Rows arrive sources in global order, each in stable owner order;
    2-D, bool and int32 columns; the reverse exchange fills unsent rows."""
    cols, owners = [], []
    for g in range(N):
        rng = np.random.default_rng(g)
        n = 5 + 7 * g
        owners.append(torch.from_numpy(rng.integers(0, N + 1, n)))
        cols.append((torch.arange(n).view(-1, 1) * 10 + g
                     * torch.ones(1, 3, dtype=torch.int64),
                     torch.from_numpy(rng.random(n) < 0.5),
                     torch.full((n,), g, dtype=torch.int32)))
    route = parallel.plan_route(owners, MESH)
    sent = parallel.send(route, cols, MESH)
    for c, name in enumerate(("rows", "flags", "source")):
        _equal_lists(got[f"exchange.{name}"], [s[c] for s in sent])
    _equal_lists(got["exchange.back"], parallel.send_back(
        route, [s[0][:, 0] for s in sent], MESH, fill=-7))
    for d in range(N):       # sources ascending at every destination
        src = got["exchange.source"][d]
        assert (np.diff(src) >= 0).all()
    assert sum(len(s) for s in got["exchange.source"]) > 0


def test_shards_of_one_host_share_its_budget(got):
    """Each process's running tables divide the device among every shard
    on it, this process's and the other's: 8 CPU shards on one host."""
    assert [int(x) for x in got["tables_on"]] == [N, N]


@pytest.mark.parametrize("k", [31, 61])
def test_count_tables_match_per_shard(got, single, jx, k):
    limbs, counts, keep = _jax_tables(jx, *count_input(), k, 2)
    keys = got[f"k{k}.count.keys"]
    _equal_lists(keys, single[f"k{k}.count.keys"])
    _equal_lists(got[f"k{k}.count.counts"], single[f"k{k}.count.counts"])
    for s in range(N):
        kept = _per_shard(keep)[s]
        np.testing.assert_array_equal(
            limbs_from_keys(torch.from_numpy(keys[s]), k).numpy()
            .astype(np.uint32), _per_shard(limbs)[s][kept])
        np.testing.assert_array_equal(got[f"k{k}.count.counts"][s],
                                      _per_shard(counts)[s][kept])
    assert sum(len(c) for c in keys) > 500


def _live_set(seq, length, left, right, live):
    return {(bytes(np.asarray(seq[i, :length[i]], np.uint8)), int(left[i]),
             int(right[i])) for i in np.nonzero(np.asarray(live))[0]}


def _jax_fork(jx, mat, lens, k, min_cov):
    limbs, counts, keep = _jax_tables(jx, mat, lens, k, min_cov)
    out = jx.par.build_initial_records_sharded(
        limbs, counts, keep, k=k, min_error=MIN_ERROR, mesh=jx.mesh)
    assert int(np.asarray(out[5]).sum()) == 0
    return out


def test_fork_records_match_per_shard(got, single, jx):
    for name in ("seq", "left", "right"):
        _equal_lists(got[f"k31.fork.{name}"], single[f"k31.fork.{name}"])
    out = _jax_fork(jx, *count_input(), 31, 2)
    for s in range(N):
        seq = got["k31.fork.seq"][s]
        mine = _live_set(seq, [31] * len(seq), got["k31.fork.left"][s],
                         got["k31.fork.right"][s], np.ones(len(seq), bool))
        assert mine == _live_set(*(_per_shard(x)[s] for x in out[:5]))
    assert sum(len(s) for s in got["k31.fork.seq"]) > 500


def _round_input(got):
    """The round's input pools, rebuilt from the fork records as
    :func:`slice_outputs` lays them out."""
    recs = [Records(torch.from_numpy(s), torch.full((len(s),), 31,
                                                    dtype=torch.int32),
                    torch.from_numpy(lf), torch.from_numpy(rt),
                    torch.ones(len(s), dtype=torch.bool))
            for s, lf, rt in zip(got["k31.fork.seq"], got["k31.fork.left"],
                                 got["k31.fork.right"])]
    rows = max(2 * max(r.capacity for r in recs), 16)
    return [pk.from_records(parallel._pad_rows(r, rows, 64)) for r in recs]


def _to_jax(jx, pools):
    cat = [torch.cat(cols).numpy() for cols in zip(*pools)]
    return jx.pk.PackedRecords(jx.jnp.asarray(cat[0].astype(np.uint32)),
                               *(jx.jnp.asarray(c) for c in cat[1:]))


def _packed(got, prefix):
    return [pk.PackedRecords(*(torch.from_numpy(got[f"{prefix}.{f}"][s])
                               for f in pk.PackedRecords._fields))
            for s in range(N)]


def test_round_and_census_match_per_shard(got, single, jx):
    for f in pk.PackedRecords._fields:
        _equal_lists(got[f"k31.round.{f}"], single[f"k31.round.{f}"])
    _equal_lists(got["k31.census"], single["k31.census"])
    want, ovf = jx.par.extension_round_sharded_packed(
        _to_jax(jx, _round_input(got)), jx.jnp.uint32(1), k=31,
        mesh=jx.mesh, cap_factor=N)
    assert int(np.asarray(ovf).sum()) == 0
    pools = _packed(got, "k31.round")
    merged = 0
    for s, p in enumerate(pools):
        live = p.live.numpy()
        wl = _per_shard(want.live)[s].astype(bool)
        np.testing.assert_array_equal(p.seq.numpy()[live],
                                      _per_shard(want.seq)[s][wl])
        for f in ("length", "left", "right"):
            np.testing.assert_array_equal(getattr(p, f).numpy()[live],
                                          _per_shard(getattr(want, f))[s][wl])
        merged += int((p.length[p.live] > 31).sum())
    assert merged > 20
    rows = max(p.capacity for p in pools)
    padded = [parallel._pad_rows(p, rows, p.limb_capacity) for p in pools]
    jmask = jx.par.finished_mask_sharded(_to_jax(jx, padded), k=31,
                                         mesh=jx.mesh)
    np.testing.assert_array_equal(np.concatenate(got["k31.census"]),
                                  np.asarray(jmask))


def test_census_after_rounds_matches(got, jx):
    """Twenty sharded rounds, then the census: some rows are finished,
    not all; equal to the single-controller mesh and the JAX census."""
    pools, mask = rounds_then_census(got["k31.fork.seq"],
                                     got["k31.fork.left"],
                                     got["k31.fork.right"], MESH)
    for f in pk.PackedRecords._fields:
        _equal_lists(got[f"rounds.{f}"], [getattr(p, f) for p in pools])
    _equal_lists(got["rounds.census"], mask)
    jmask = jx.par.finished_mask_sharded(_to_jax(jx, pools), k=31,
                                         mesh=jx.mesh)
    np.testing.assert_array_equal(torch.cat(mask).numpy(),
                                  np.asarray(jmask))
    fin = int(torch.cat(mask).sum())
    assert 0 < fin < sum(int(p.live.sum()) for p in pools)


def test_mixed_k_round_on_fork_records_matches_per_shard(got, single):
    for f in pd.FlatPool._fields:
        _equal_lists(got[f"k31.dyn.{f}"], single[f"k31.dyn.{f}"])
    assert sum(len(x) for x in got["k31.dyn.length"]) < \
        sum(len(x) for x in got["k31.fork.seq"])


def test_mercy_table_matches(got, jx):
    mat, lens = gap_input()
    keys, counts = parallel.mercy_kmer_table_sharded(mat, lens, k=21,
                                                     min_cov=3, mesh=MESH)
    np.testing.assert_array_equal(np.concatenate(got["mercy.keys"]),
                                  keys.numpy())
    np.testing.assert_array_equal(np.concatenate(got["mercy.counts"]),
                                  counts.numpy())
    jl, jc = jx.par.mercy_kmer_table_sharded(mat, lens, k=21, min_cov=3,
                                             mesh=jx.mesh)
    from reflexiv_tpu_torch.bitpack import keys_from_limbs

    table = dict(zip(keys.tolist(), counts.tolist()))
    assert table == dict(zip(keys_from_limbs(np.asarray(jl), 21).tolist(),
                             np.asarray(jc).tolist()))
    assert any(v < 3 for v in table.values())


def _dyn_rows(limbs, length, subk, left, right):
    """(bases, subk, left, right) per row of a flat pool."""
    dense = pd.to_dense(pd.FlatPool(*(torch.from_numpy(np.asarray(a))
                                      for a in (limbs, length, subk, left,
                                                right)))).numpy()
    bases = unpack_seq_matrix_np(dense.astype(np.uint32),
                                 dense.shape[1] * 16)
    return list(zip((b[:n].tobytes() for b, n in zip(bases, length)),
                    np.asarray(subk).tolist(), np.asarray(left).tolist(),
                    np.asarray(right).tolist()))


def test_mixed_k_rounds_match_per_shard_limb_for_limb(got, jx):
    """Two rounds from ``_pad_pdyn``'s layout: each shard's flat pool
    equals the single-controller shard's limb for limb, and its rows the
    JAX shard's live rows in order."""
    fp, pool = stage0_flat()
    cap = meta._mesh_capacity(fp.n, N)
    shards = parallel.pad_pdyn([fp], cap, MESH)

    def pad(a):
        out = np.zeros((4096,) + np.asarray(a).shape[1:], np.asarray(a).dtype)
        out[:len(a)] = a
        return jx.jnp.asarray(out)

    jp = jx.dyn._pad_pdyn(jx.pd.PackedDynRecords(*(pad(a) for a in pool)),
                          cap)
    M = cap // N
    for it in (1, 2):
        shards = parallel.pdyn_extension_round_sharded(
            shards, it, kmin=KLIST[0], max_sub=KLIST[-1] - 1, mesh=MESH,
            cap=cap)
        jp, ovf = jx.par.pdyn_extension_round_sharded(
            jp, jx.jnp.uint32(it), kmin=KLIST[0], max_sub=KLIST[-1] - 1,
            mesh=jx.mesh, cap_factor=4)
        assert int(np.asarray(ovf).sum()) == 0
        for f in pd.FlatPool._fields:
            _equal_lists(got[f"dyn{it}.{f}"], [getattr(p, f) for p in shards])
        for s in range(N):
            part = [np.asarray(a)[s * M:(s + 1) * M] for a in jp]
            live = part[5].astype(bool)
            want = _dyn_rows(*pd.from_dense(part[0][live],
                                            *(a[live] for a in part[1:5])))
            mine = _dyn_rows(*(got[f"dyn{it}.{f}"][s]
                               for f in pd.FlatPool._fields))
            assert mine == want
    assert sum(len(x) for x in got["dyn2.length"]) < fp.n


def test_overflow_returns_none_on_every_process(got):
    """At a capacity where a shard of only one process ends over cap / N
    rows, both processes return None (the single-controller mesh too)."""
    fp = random_flat()
    cap, sizes = overflow_cap(fp)
    over = {s // LOCAL for s, n in enumerate(sizes) if n > cap // N}
    assert len(over) == 1 and sum(sizes) == fp.n
    assert [bool(x) for x in got["overflow.none"]] == [True, True]
    assert parallel.pdyn_extension_round_sharded(
        parallel.pad_pdyn([fp], cap, MESH), 1, kmin=31, max_sub=30,
        mesh=MESH, cap=cap) is None
    # with room for the largest shard, the round goes through
    room = N * max(sizes)
    assert parallel.pdyn_extension_round_sharded(
        parallel.pad_pdyn([fp], room, MESH), 1, kmin=31, max_sub=30,
        mesh=MESH, cap=room) is not None


def test_all_padding_process_finishes(got, jx):
    """Three reads over 8 shards: process 1's block is all padding rows,
    and it still joins every exchange; tables and fork records equal the
    single-controller mesh's and the JAX package's."""
    mat, lens = tiny_input()
    assert [int(x) for x in got["tiny.live_reads"]] == [3, 0]
    tables = parallel.count_kmers_sharded(mat, lens, k=21, min_cov=1,
                                          mesh=MESH)
    _equal_lists(got["tiny.count.keys"], [t for t, _ in tables])
    recs = parallel.build_initial_records_sharded(
        tables, k=21, min_error=MIN_ERROR, mesh=MESH)
    _equal_lists(got["tiny.fork.seq"], [r.seq for r in recs])
    limbs, _counts, keep = _jax_tables(jx, mat, lens, 21, 1)
    for s in range(N):
        np.testing.assert_array_equal(
            limbs_from_keys(torch.from_numpy(got["tiny.count.keys"][s]), 21)
            .numpy().astype(np.uint32),
            _per_shard(limbs)[s][_per_shard(keep)[s]])
    assert sum(len(k) for k in got["tiny.count.keys"]) > 50


def _env():
    """The children's environment: the repo on the path, and two threads
    each, so that processes beside other test workers do not crowd the
    cores."""
    return dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _run(argv, timeout=CHILD_TIMEOUT):
    return subprocess.run([sys.executable, "-m"] + argv, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def test_torch_threads_shares_the_cores_among_xdist_workers(monkeypatch):
    """``torch_threads`` gives each xdist worker's torch pool
    ``max(1, cpus // workers)`` threads when imported, and leaves the pool
    alone outside xdist."""
    share = torch_threads.thread_share()
    if share is not None:
        assert torch.get_num_threads() == share
    monkeypatch.setattr(torch_threads.os, "sched_getaffinity",
                        lambda pid: set(range(8)))
    for workers, want in (("1", 8), ("3", 2), ("6", 1), ("16", 1)):
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
        assert torch_threads.thread_share() == want
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
    before = torch.get_num_threads()
    torch_threads.apply_share()
    assert torch_threads.thread_share() is None
    assert torch.get_num_threads() == before


def test_multiprocess_smoke_module_on_cpu():
    r = _run(["reflexiv_tpu_torch.multiprocess_smoke", "-device", "cpu"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count(": OK - counting distinct=") == 2
    assert "over 8 shards / 2 processes (gloo, cpu)" in r.stdout


def test_multihost_count_module_on_cpu(tmp_path):
    """Two processes of 2 CPU shards, joined through a file store, count
    the distinct k-mers of the one-card table."""
    mat, lens = count_input()
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as fh:
        for i, (row, n) in enumerate(zip(mat, lens)):
            fh.write(f"@r{i}\n{''.join('ACGT'[c] for c in row[:n])}\n+\n"
                     f"{'I' * n}\n")
    want = count_kmers(mat, lens, k=31, min_cov=2, device="cpu")[1].numel()
    argv = [sys.executable, "-m", "reflexiv_tpu_torch.multihost_count",
            "--fastq", str(fq), "-device", "cpu", "--local-shards", "2",
            "--coordinator", "file://" + str(tmp_path / "store"),
            "--num-hosts", "2"]
    outs = run_children([argv + ["--host-id", str(i)] for i in range(2)],
                        timeout_s=CHILD_TIMEOUT, env=_env())
    for out in outs:
        assert "mesh: 4 shards over 2 process(es)" in out, out
        assert f", {want} distinct k-mers)" in out, out


def test_nccl_needs_one_card_per_process():
    with pytest.raises(ValueError, match="one card"):
        init_process_mesh(backend="nccl", init_method="file:///nonexistent",
                          world_size=2, rank=0, local_devices=["cpu"])


@pytest.mark.cuda
def test_nccl_pair_on_two_cards():
    """On a machine with two or more cards: the smoke's two processes,
    one a card, over NCCL."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    r = _run(["reflexiv_tpu_torch.multiprocess_smoke"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "over 2 shards / 2 processes (nccl, cuda:1)" in r.stdout


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _run(["reflexiv_tpu_torch.multiprocess_smoke", "-device", "cuda:0",
              "--backend", "nccl"])
    assert r.returncode != 0
    assert "nccl refuses two ranks on one card" in r.stdout + r.stderr


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    job(a.rank, a.init, a.out)
