"""Sharded counting over several processes, the counterpart of
``scripts/multihost_count.py``.

Run one process per host (or per card) with the same flags but
``--host-id``; each loads the reads, keeps its block of the read matrix
(padded to a multiple of the shard count, process p's rows ``[p * R_pad / P,
(p + 1) * R_pad / P)``) and counts it with
:func:`parallel.count_kmers_sharded` on a :class:`distributed.ProcessMesh`:

    python -m reflexiv_tpu_torch.multihost_count \\
        --coordinator HOST0:PORT --num-hosts N --host-id I \\
        --fastq 'reads*.fq.gz' --k 31 --min-cov 2 [-device cuda] \\
        [--backend nccl] [--local-shards 1]

``--coordinator`` is ``host:port`` (a TCP store on host 0) or any
``torch.distributed`` init URL (``file:///shared/path``). Without it one
process counts on a :class:`parallel.Mesh` of ``--local-shards`` shards.
One process per card on one machine: start process I with ``-device
cuda:I``. The backend defaults to ``nccl`` on a card and ``gloo`` on the
CPU.

It warms up once, then times 3 passes, and prints ``mesh: n shards over P
process(es)``, then the rate in Mkmers/s (the windows of every process's
reads over the slowest process's mean pass), the ms per pass and the
global distinct k-mer count.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

PASSES = 3
TIMEOUT_S = 600      # seconds each collective may wait


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host 0's address:port, or an init URL")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--fastq", required=True)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--min-cov", type=int, default=2)
    ap.add_argument("-device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on a card, gloo on "
                         "the CPU)")
    ap.add_argument("--local-shards", type=int, default=1)
    args = ap.parse_args(argv)

    from . import parallel
    from .device import resolve_device, synchronize
    from .distributed import init_process_mesh
    from .io import load_reads
    from .multiprocess_smoke import block

    devices = [args.device] * args.local_shards
    if args.coordinator:
        backend = args.backend or ("gloo" if resolve_device(args.device)
                                   .type == "cpu" else "nccl")
        init = args.coordinator if "://" in args.coordinator \
            else f"tcp://{args.coordinator}"
        mesh = init_process_mesh(
            backend=backend, init_method=init, world_size=args.num_hosts,
            rank=args.host_id, local_devices=devices, timeout_s=TIMEOUT_S)
        world, rank = mesh.world, mesh.rank
    else:
        mesh, world, rank = parallel.make_mesh(devices), 1, 0
    n = mesh.size
    print(f"mesh: {n} shards over {world} process(es)", flush=True)

    mat, lens = load_reads(args.fastq)
    n_kmers = int(np.maximum(lens.astype(np.int64) - args.k + 1, 0).sum())
    bases, lengths = (block(a, rank, world, n) for a in (mat, lens))

    def run():
        out = parallel.count_kmers_sharded(
            bases, lengths, k=args.k, min_cov=args.min_cov, mesh=mesh)
        for dev in set(mesh.devices):
            synchronize(dev)
        return out

    run()                                    # warm-up
    mesh.allgather_ints([0])                 # every process starts together
    t0 = time.perf_counter()
    for _ in range(PASSES):
        out = run()
    dt = (time.perf_counter() - t0) / PASSES
    slowest = max(r[0] for r in mesh.allgather_ints([int(dt * 1e6)])) / 1e6
    distinct = sum(r[0] for r in mesh.allgather_ints(
        [sum(c.numel() for _, c in out)]))
    print(f"counting: {n_kmers / slowest / 1e6:.1f} Mkmers/s over {n} "
          f"shards ({slowest * 1e3:.0f} ms/pass, {distinct} distinct "
          f"k-mers)", flush=True)
    if args.coordinator:
        mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
