"""Multi-process smoke of the process mesh, the counterpart of
``scripts/multiprocess_smoke.py`` (two ``jax.distributed`` processes of 4
CPU devices each).

The parent spawns ``--procs`` children (default 2) that join one
:class:`distributed.ProcessMesh` of ``--local-shards`` shards each (default
4 on the CPU, 1 on a card) and run, with every exchange crossing the
process boundary:

  (a) sharded canonical counting at k = 31, ``MIN_COV`` = 2
      (:func:`parallel.count_kmers_sharded`) on synthetic reads, each child
      feeding its block of the padded read matrix; the global distinct and
      total counts must equal a scalar string oracle's;
  (b) one sharded mixed-k round (:func:`parallel.pdyn_extension_round_sharded`,
      the JAX mesh loop's bucket factor 4) over both strands of a 200 bp
      fragment's 31-mers (``subk`` 30, ``left = right = -1``): its live
      count must equal the single-device
      :func:`packed_dyn.pdyn_extension_round_fused` round's and fall below
      the row count.

Each child prints its line; the parent exits non-zero if any child fails or
outlives ``TIMEOUT_S``, and then kills the rest.

Usage (2 NCCL processes, one a card; 2 gloo processes x 4 CPU shards; 2
gloo processes x 2 shards of one card):
    python -m reflexiv_tpu_torch.multiprocess_smoke
    python -m reflexiv_tpu_torch.multiprocess_smoke -device cpu
    python -m reflexiv_tpu_torch.multiprocess_smoke -device cuda:0 \\
        --backend gloo --local-shards 2

The backend defaults to ``nccl`` for a card and ``gloo`` for the CPU.
``-device cuda`` puts child r on card r (one process per card); ``cuda:N``
puts every child on card N (gloo only: NCCL refuses two ranks on a card).
"""
from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

N_PROCS = 2
TIMEOUT_S = 300      # seconds a child may take, and each collective
K = 31
MIN_COV = 2
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def synthetic_reads(n_reads: int = 64, read_len: int = 100, seed: int = 99):
    """A random 600 bp genome and reads of it, half reverse-complemented
    (the JAX smoke's input)."""
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(600))
    reads = []
    for _ in range(n_reads):
        s = rng.randrange(len(genome) - read_len + 1)
        r = genome[s:s + read_len]
        reads.append(_revcomp(r) if rng.random() < 0.5 else r)
    return genome, reads


def oracle_counts(reads, k: int, min_cov: int):
    """Scalar canonical counting oracle (strings and a dict): the distinct
    k-mers at ``min_cov`` or more, and their summed counts."""
    table: dict = {}
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i:i + k]
            c = min(w, _revcomp(w))
            table[c] = table.get(c, 0) + 1
    kept = {w: c for w, c in table.items() if c >= min_cov}
    return len(kept), sum(kept.values())


def local_devices(device: str, rank: int, local: int) -> List[str]:
    """Child ``rank``'s shards: ``local`` of ``device``, where a bare
    ``cuda`` means card ``rank``."""
    return [f"cuda:{rank}" if device == "cuda" else device] * local


def block(a: np.ndarray, rank: int, world: int, shards: int) -> np.ndarray:
    """Process ``rank``'s rows of ``a`` padded with zero rows to a multiple
    of ``shards``: ``[rank * R_pad / world, (rank + 1) * R_pad / world)``,
    as ``jax.make_array_from_process_local_data`` is fed."""
    R_pad = -(-a.shape[0] // shards) * shards
    out = np.zeros((R_pad,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out[rank * R_pad // world:(rank + 1) * R_pad // world]


def most(mesh, values: Sequence[int]) -> int:
    """The largest of ``values`` over every process of ``mesh``."""
    return max(max(r) for r in mesh.allgather_ints([max(values, default=0)]))


def slice_outputs(bases, lengths, *, k: int, min_cov: int, min_error: int,
                  mesh, seed: int = 1, plain: bool = False
                  ) -> Dict[str, List[torch.Tensor]]:
    """The sharded functions that have a process form, in the order the
    single-k path runs them, over this process's block of one input:
    :func:`parallel.count_kmers_sharded`,
    :func:`parallel.build_initial_records_sharded`, one
    :func:`parallel.extension_round_sharded_packed` (seed ``seed``) from
    the records laid out in equal rows, :func:`parallel.finished_mask_sharded`
    on its result, and one :func:`parallel.pdyn_extension_round_sharded`
    on the records as :class:`packed_dyn.FlatPool` rows (``subk = k - 1``).
    Returns each output's local shards by name. A
    :class:`distributed.ProcessMesh` and a :class:`parallel.Mesh` over the
    same global layout give equal lists, shard for shard."""
    from . import packed as pk
    from . import packed_dyn as pd
    from . import parallel
    from .records import next_pow2

    out: Dict[str, List[torch.Tensor]] = {}
    tables = parallel.count_kmers_sharded(bases, lengths, k=k,
                                          min_cov=min_cov, mesh=mesh,
                                          plain=plain)
    out["count.keys"] = [t for t, _ in tables]
    out["count.counts"] = [c for _, c in tables]
    recs = parallel.build_initial_records_sharded(
        tables, k=k, min_error=min_error, mesh=mesh)
    del tables
    for name in ("seq", "left", "right"):
        out[f"fork.{name}"] = [getattr(r, name) for r in recs]
    rows = max(2 * most(mesh, [r.capacity for r in recs]), 16)
    pools = [pk.from_records(parallel._pad_rows(r, rows, max(64, k + 1)))
             for r in recs]
    pools = parallel.extension_round_sharded_packed(pools, seed, k=k,
                                                    mesh=mesh)
    for name, col in zip(pk.PackedRecords._fields, zip(*pools)):
        out[f"round.{name}"] = list(col)
    rows = most(mesh, [p.capacity for p in pools])
    pools = [parallel._pad_rows(p, rows, p.limb_capacity) for p in pools]
    out["census"] = parallel.finished_mask_sharded(pools, k=k, mesh=mesh)
    del pools
    flat = [pd.from_dense(pk.from_records(r).seq, r.length,
                          torch.full_like(r.length, k - 1), r.left, r.right)
            for r in recs]
    del recs
    cap = mesh.size * max(16, next_pow2(2 * most(mesh, [f.n for f in flat])))
    got = parallel.pdyn_extension_round_sharded(
        flat, seed, kmin=k, max_sub=k - 1, mesh=mesh, cap=cap)
    if got is None:
        raise RuntimeError(f"the mixed-k round overflowed at cap {cap}")
    for name, col in zip(pd.FlatPool._fields, zip(*got)):
        out[f"dyn.{name}"] = list(col)
    return out


# ---------------------------------------------------------------------------
# spawning the children
# ---------------------------------------------------------------------------

def run_children(argvs: List[List[str]], *, timeout_s: float,
                 env: Dict[str, str] = None) -> List[str]:
    """Start one process per argv and wait for all of them; returns their
    outputs (stdout and stderr), in order. Where one exits non-zero, or
    ``timeout_s`` passes first, every other is killed and RuntimeError
    raised with the outputs."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [PKG_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    logs = [tempfile.TemporaryFile(mode="w+") for _ in argvs]
    procs = [subprocess.Popen(a, stdout=log, stderr=subprocess.STDOUT,
                              env=env) for a, log in zip(argvs, logs)]
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = f"child {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"a child outlived its {timeout_s:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed or bad:
        raise RuntimeError(
            (failed or f"child {bad[0]} exited {procs[bad[0]].returncode}")
            + "".join(f"\n--- child {i} ---\n{o[-4000:]}"
                      for i, o in enumerate(outs)))
    return outs


def child(args) -> None:
    from . import packed as pk
    from . import packed_dyn as pd
    from . import parallel
    from .distributed import init_process_mesh
    from .io import reads_to_matrix
    from .records import next_pow2

    rank, world = args.child, args.procs
    mesh = init_process_mesh(
        backend=args.backend, init_method=args.init_method,
        world_size=world, rank=rank,
        local_devices=local_devices(args.device, rank, args.local_shards),
        timeout_s=TIMEOUT_S)
    n = mesh.size
    dev = mesh.devices[0]

    # (a) sharded counting across the process boundary
    genome, reads = synthetic_reads(seed=args.seed)
    mat, lens = reads_to_matrix([r.encode() for r in reads])
    tables = parallel.count_kmers_sharded(
        block(mat, rank, world, n), block(lens, rank, world, n), k=K,
        min_cov=MIN_COV, mesh=mesh)
    distinct, total = (sum(col) for col in zip(*mesh.allgather_ints([
        sum(c.numel() for _, c in tables),
        sum(int(c.sum()) for _, c in tables)])))
    want = oracle_counts(reads, K, MIN_COV)
    if (distinct, total) != want:
        raise SystemExit(f"proc {rank}: counting distinct, total "
                         f"{(distinct, total)} != oracle {want}")

    # (b) one sharded mixed-k round across the processes
    frag = genome[:200]
    wins = [t for i in range(len(frag) - K + 1)
            for t in (frag[i:i + K], _revcomp(frag[i:i + K]))]
    codes, wlens = reads_to_matrix([w.encode() for w in wins])
    length = torch.from_numpy(wlens).to(dev)
    fp = pd.from_dense(pk.pack_seq_matrix(torch.from_numpy(codes).to(dev)),
                       length, torch.full_like(length, K - 1),
                       torch.full_like(length, -1),
                       torch.full_like(length, -1))
    cap = -(-max(next_pow2(len(wins)), 16) // n) * n
    live_want = pd.pdyn_extension_round_fused(fp, 1, kmin=K,
                                              max_sub=K - 1)[1]
    got = parallel.pdyn_extension_round_sharded(
        parallel.pad_pdyn([fp], cap, mesh), 1, kmin=K, max_sub=K - 1,
        mesh=mesh, cap=cap)
    if got is None:
        raise SystemExit(f"proc {rank}: the mixed-k round overflowed")
    live_got = sum(r[0] for r in mesh.allgather_ints([sum(p.n for p in got)]))
    if live_got != live_want or live_got >= len(wins):
        raise SystemExit(f"proc {rank}: round live {live_got}, single "
                         f"device {live_want}, rows {len(wins)}")
    print(f"proc {rank}: OK - counting distinct={distinct} total={total}; "
          f"round live {len(wins)} -> {live_got} over {n} shards / {world} "
          f"processes ({args.backend}, {dev})", flush=True)
    mesh.close()


def parent(args) -> int:
    if args.device != "cpu":
        from .kernels import build

        build.lib()        # once here, so that no child times a build
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        argv = [sys.executable, "-m", "reflexiv_tpu_torch.multiprocess_smoke",
                "-device", args.device, "--backend", args.backend,
                "--procs", str(args.procs), "--local-shards",
                str(args.local_shards), "--seed", str(args.seed),
                "--init-method", init]
        try:
            outs = run_children([argv + ["--child", str(r)]
                                 for r in range(args.procs)],
                                timeout_s=TIMEOUT_S)
        except RuntimeError as e:
            print(f"multiprocess smoke: FAILED: {e}", flush=True)
            return 1
    for out in outs:
        sys.stdout.write(out)
    print("multiprocess smoke: OK", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on a card, gloo on "
                         "the CPU)")
    ap.add_argument("--procs", type=int, default=N_PROCS)
    ap.add_argument("--local-shards", type=int, default=None,
                    help="shards per process (default: 4 on the CPU, 1 on "
                         "a card)")
    ap.add_argument("--seed", type=int, default=99)
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    if args.backend is None:
        args.backend = "gloo" if cpu else "nccl"
    if args.local_shards is None:
        args.local_shards = 4 if cpu else 1
    if args.child is None:
        return parent(args)
    child(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
