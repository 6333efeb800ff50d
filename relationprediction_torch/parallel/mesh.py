"""Edge-partitioned execution over ``torch.distributed``
(``relationprediction_tpu/parallel/mesh.py``).

One process a rank (``distributed.launch`` starts them). Every rank holds
the whole parameter tree and a contiguous block of each step's work:

* the message graph's edges, padded to a multiple of lcm(8, n) and cut
  into n blocks (``graph.shard_edges``), each weighted by the whole
  graph's degrees (``graph.build_graph_batch(shard=...)``): a layer sums
  its block into all V rows with the card's kernels, and
  ``collectives.all_reduce_sum`` adds the partial [V, d] sums into the
  whole graph's aggregation (``encoders.apply_gcn_layer(group=...)``);
* the loss rows (positives, or a tiled batch), padded to a multiple of
  lcm(8, n) or lcm(128, n) (``BatchPipeline(shard_multiple=)``) and cut
  likewise (``shard_batch``): every mean of the loss all-reduces its sum
  and its count before it divides, so each rank holds the global loss;
* the gradients, all-reduced in one flat tensor and divided by the world
  size (``collectives.pmean``, the JAX package's pmean), then the
  unchanged optimiser (``engine.make_sharded_train_step``), so that the
  params stay equal bit for bit on every rank.

The scaling (``mesh.py:142-151`` there): ``all_reduce_sum``'s backward
all-reduces its cotangent, the transpose of a sum over ranks, so each
rank's backward from its copy of the global loss gives N times its own
share of the gradient, and the mean over ranks is the loss's gradient. A
sum in place of the mean scales the update by N; Adam's scale invariance
hides that, plain SGD does not.

The backend is the process group's: NCCL on cards (one rank a card) and
gloo on the CPU and for several ranks that share one card.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..params import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class EdgeMesh:
    """This rank's view of a 1-D edge-partition mesh: its rank among
    ``world_size``, the process group of the mesh's collectives, the
    device its work runs on, and the group's backend."""

    rank: int
    world_size: int
    group: dist.ProcessGroup
    device: torch.device
    backend: str

    @property
    def shard(self) -> tuple:
        return self.rank, self.world_size


def local_world_size() -> int:
    """Ranks on this host (``LOCAL_WORLD_SIZE``, set by
    ``distributed.init_runtime``; the whole world where unset)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def check_devices(backend: str, devices: Sequence[torch.device],
                  local: int) -> None:
    """Raise ValueError where NCCL is given a device it cannot take: a
    CPU, or a card that two ranks of one host (``local`` ranks a host, in
    rank order) share. Gloo takes any list."""
    if backend != "nccl":
        return
    if any(d.type != "cuda" for d in devices):
        raise ValueError("NCCL runs on CUDA devices only; use gloo for CPU "
                         "ranks")
    for host in range(0, len(devices), local):
        on_host = [d.index for d in devices[host:host + local]]
        if len(set(on_host)) != len(on_host):
            raise ValueError(f"NCCL takes one rank a card, and ranks "
                             f"{host}-{host + local - 1} share cards "
                             f"{on_host}; put several ranks on one card "
                             f"with the gloo backend")


def make_mesh(devices: Optional[Sequence] = None) -> EdgeMesh:
    """This rank's ``EdgeMesh`` over the initialized default process group
    (``make_mesh`` of the JAX package, ``:39-46``), whose size is the
    world's and whose backend is the group's.

    ``devices``: one torch device a rank, in rank order; by default
    ``cuda:<local rank>``, whatever the backend: a CPU mesh lists the CPU
    for every rank. A list that repeats a card puts several gloo ranks on
    it (``check_devices``). Raises RuntimeError without a process
    group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "start the ranks with distributed.launch or "
                           "call distributed.init_runtime")
    world, rank = dist.get_world_size(), dist.get_rank()
    backend, local = dist.get_backend(), local_world_size()
    if devices is None:
        devices = [f"cuda:{r % local}" for r in range(world)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    check_devices(backend, devices, local)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return EdgeMesh(rank, world, dist.group.WORLD, device, backend)


def replicate(mesh: EdgeMesh, tree):
    """Rank 0's tree (params, optimizer state) on every rank, on the
    mesh's device (``replicate``, ``:195-208``): each leaf is copied, then
    broadcast from rank 0, so the result never aliases the caller's
    tensors."""
    leaves = [leaf.detach().to(mesh.device, copy=True).contiguous()
              for leaf in tree_leaves(tree)]
    for leaf in leaves:
        dist.broadcast(leaf, src=0, group=mesh.group)
    return tree_unflatten(tree, leaves)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def shard_rows(n_rows: int, shard: tuple) -> slice:
    """Rank ``shard[0]``'s contiguous block of a leading axis of ``n_rows``
    padded rows split over ``shard[1]`` ranks (the JAX package's
    ``P(EDGE_AXIS)``)."""
    rank, n = shard
    if n_rows % n:
        raise ValueError(f"leading dim {n_rows} not divisible by the mesh "
                         f"size {n}")
    per = n_rows // n
    return slice(rank * per, (rank + 1) * per)


def shard_batch(mesh_or_shard, batch):
    """A ``TrainBatch`` (engine.py) with this rank's block of the padded
    loss rows (triples, mask, labels). Its graph must be this rank's shard
    already (``BatchPipeline`` builds only that), or None."""
    shard = mesh_or_shard.shard if isinstance(mesh_or_shard, EdgeMesh) \
        else tuple(mesh_or_shard)
    if batch.graph is not None and batch.graph.shard != shard:
        raise ValueError(f"the batch's graph is shard {batch.graph.shard}, "
                         f"not this rank's {shard}")
    rows = shard_rows(batch.triples.shape[0], shard)
    return batch._replace(
        triples=batch.triples[rows], mask=batch.mask[rows],
        labels=None if batch.labels is None else batch.labels[rows])
