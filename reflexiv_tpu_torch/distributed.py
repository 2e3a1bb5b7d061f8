"""The process mesh: the sharded functions of :mod:`parallel` over several
processes, their exchange over ``torch.distributed``.

The JAX package's ``shard_map`` functions take global arrays, and after
``jax.distributed.initialize`` their ``all_to_all`` calls cross process
boundaries (``scripts/multiprocess_smoke.py``, ``scripts/multihost_count
.py``). Here each process holds ``L`` local shards (the same ``L`` on every
process, as ``jax.distributed`` requires equal local device counts), and
global shard ``g = rank * L + i`` is local shard ``i`` of process
``rank``: the order of ``jax.devices()`` across processes, process 0's
devices first. A :class:`ProcessMesh` stands where :class:`parallel.Mesh`
does: ``devices`` are this process's shards, ``size`` the global shard
count and ``first`` the global index of local shard 0. A sharded function
takes this process's block of the global input and returns its local
shards' outputs, as a JAX process holds the addressable shards of a
global array.

The backend is the caller's choice and is never probed or swapped:

- ``nccl``: the shards of one process live on one card (one process per
  card is the usual form). NCCL refuses two ranks on one card; that error
  surfaces from :func:`init_process_mesh` saying so.
- ``gloo``: CPU shards (the tests), or card shards. gloo's
  ``all_to_all_single``, ``all_gather`` and ``all_reduce`` take CUDA
  tensors and copy them through host memory themselves (torch 2.11+cu128
  on an H100), so the card's tensors go to gloo as they are.

Every exchange is one ``all_to_all_single`` per column, split on dim 0,
and every size table one ``all_gather``: each process makes the same calls
in the same order, or the group times out (``timeout_s``).
"""
from __future__ import annotations

import datetime
import socket
from typing import List, Sequence

import torch
import torch.distributed as dist

from .parallel import make_mesh


class ProcessMesh:
    """This process's part of a mesh of ``world * L`` shards (see the
    module docstring). Made by :func:`init_process_mesh`."""

    def __init__(self, group, rank: int, world: int,
                 devices: Sequence[torch.device], shares: Sequence[int]):
        self.group, self.rank, self.world = group, rank, world
        self.devices = tuple(devices)
        self._shares = dict(zip(self.devices, shares))
        # where the exchange's buffers live: nccl and gloo both take the
        # first local shard's tensors (a CPU tensor, or a card's)
        self.transport = self.devices[0]

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.world * self.local

    @property
    def first(self) -> int:
        return self.rank * self.local

    def tables_on(self, dev: torch.device) -> int:
        """Shards on ``dev``'s card over every process of this host."""
        return self._shares[dev]

    def allgather_ints(self, values: Sequence[int]) -> List[List[int]]:
        """Every process's ``values`` (equal lengths), in rank order: one
        ``all_gather`` and one host read."""
        t = torch.tensor(list(values), dtype=torch.int64,
                         device=self.transport)
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out).tolist()

    def size_table(self, rows: List[torch.Tensor]) -> List[List[int]]:
        """The global ``size x size`` table whose row ``first + i`` is
        ``rows[i]`` (a length-``size`` int64 tensor per local shard)."""
        t = torch.stack([r.to(self.transport) for r in rows]).reshape(-1)
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out).reshape(self.size, -1).tolist()

    def exchange(self, parts: List[List[torch.Tensor]],
                 recv: List[List[int]]) -> List[List[torch.Tensor]]:
        """One column's all-to-all: ``parts[a][B]`` is what local shard
        ``a`` sends to global shard ``B``; ``recv[b][A]`` the rows local
        shard ``b`` gets from global shard ``A``. Returns ``out[b][A]``,
        on local shard ``b``'s device.

        Wire layout: process q's buffer to process p holds, for each of
        p's local shards j and each of q's local shards a, the slice
        ``a -> p * L + j``; the receiver cuts it by ``recv`` (so by
        source process, then j, then a) and regroups it per j."""
        L, P, dev = self.local, self.world, self.transport
        like = parts[0][0]
        wire = torch.uint8 if like.dtype == torch.bool else like.dtype
        pieces = [parts[a][p * L + j] for p in range(P) for j in range(L)
                  for a in range(L)]
        send = torch.cat([x.to(dev, wire) for x in pieces])
        in_sizes = [sum(x.shape[0] for x in pieces[p * L * L:(p + 1) * L * L])
                    for p in range(P)]
        got = [recv[j][q * L + a] for q in range(P) for j in range(L)
               for a in range(L)]
        out_sizes = [sum(got[q * L * L:(q + 1) * L * L]) for q in range(P)]
        buf = send.new_empty((sum(out_sizes),) + tuple(send.shape[1:]))
        dist.all_to_all_single(buf, send, out_sizes, in_sizes,
                               group=self.group)
        cut = buf.split(got)
        return [[cut[(q * L + j) * L + a].to(d, like.dtype,
                                             non_blocking=d.type == "cuda")
                 for q in range(P) for a in range(L)]
                for j, d in enumerate(self.devices)]

    def close(self) -> None:
        dist.destroy_process_group(self.group)


def _card_id(dev: torch.device) -> str:
    """A name for ``dev``'s card that is the same in every process of its
    host, whatever each process's visible devices are."""
    if dev.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(dev)
    return str(getattr(props, "uuid", dev.index))


def init_process_mesh(*, backend: str, init_method: str, world_size: int,
                      rank: int, local_devices: Sequence,
                      timeout_s: float = 300.0) -> ProcessMesh:
    """Join the group (``torch.distributed.init_process_group`` with
    ``backend``, ``init_method`` such as ``tcp://host:port`` or
    ``file:///path``, and ``timeout_s`` seconds for every collective) and
    return this process's :class:`ProcessMesh` over ``local_devices``
    (checked as :func:`parallel.make_mesh` checks a mesh's devices; a bare
    ``cuda`` is the current card). Under ``nccl`` every local shard must
    be on one card, which becomes the current device. Every process must
    give as many local devices."""
    devs = make_mesh(local_devices).devices
    if backend == "nccl":
        if len(set(devs)) != 1 or devs[0].type != "cuda":
            raise ValueError(f"nccl: every local shard of a process must be "
                             f"on one card, got {[str(d) for d in devs]}")
        torch.cuda.set_device(devs[0])
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    group = dist.group.WORLD
    mesh = ProcessMesh(group, rank, world_size, devs, [1] * len(devs))
    try:
        counts = mesh.allgather_ints([len(devs)])
    except dist.DistBackendError as e:
        if "Duplicate GPU" in str(e):
            raise RuntimeError(
                f"nccl refuses two ranks on one card (rank {rank} on "
                f"{devs[0]}): give each process its own card, or use gloo"
            ) from e
        raise
    if len({c[0] for c in counts}) != 1:
        raise ValueError(f"every process needs as many local shards, got "
                         f"{[c[0] for c in counts]}")
    mine = [(socket.gethostname(), _card_id(d)) for d in devs]
    everyone: List[list] = [None] * world_size
    dist.all_gather_object(everyone, mine, group=group)
    held = [c for cards in everyone for c in cards]
    return ProcessMesh(group, rank, world_size, devs,
                       [held.count(c) for c in mine])
