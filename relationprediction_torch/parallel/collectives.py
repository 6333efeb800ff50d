"""The edge mesh's collectives over a ``torch.distributed`` process group,
which the models, the sharded step and the train loop call (the JAX
package's ``psum`` / ``pmean`` / ``all_gather`` inside its mesh step).

Every all-reduce and all-gather of the mesh path, forward and backward,
is counted in ``all_reduce_sum.calls`` and ``all_reduce_sum.bytes``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..params import tree_leaves, tree_unflatten


def _count(x: torch.Tensor) -> None:
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` (contiguous, owned by the caller) over ``group`` in
    place, counted."""
    _count(x)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(
            grad.clone(memory_format=torch.contiguous_format),
            ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (a ProcessGroup),
    differentiable: the backward all-reduces the cotangent. A new tensor;
    ``x`` is left as it is."""
    return _AllReduceSum.apply(x, group)


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n * rows, ...] on every rank from each rank's [rows, ...] block, in
    rank order, counted by the gathered bytes: NCCL gathers into one
    tensor, gloo into the views of its blocks."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _count(out)
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        dist.all_gather(list(out.chunk(n)), x, group=group)
    return out


def pmean(grads, group):
    """The mean over the ranks of ``group`` of a gradient tree: one
    all-reduce of the leaves flattened into one tensor, divided by the
    world size."""
    leaves = tree_leaves(grads)
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in leaves]), group)
    flat /= dist.get_world_size(group)
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return tree_unflatten(grads, out)


def broadcast_value(value: float, group, device) -> float:
    """Rank 0's ``value`` on every rank of ``group`` (a float64 broadcast
    from a tensor on ``device``), so that every rank takes rank 0's branch
    (the early stopper's score, the time cap)."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0, group=group)
    return float(t.item())


def graph_shard_matches(graph, group) -> None:
    """Raise ValueError unless ``graph`` is the whole graph where ``group``
    is None, or this rank's shard of ``group``'s ranks: a shard summed
    without the all-reduce, or the whole graph summed on every rank, would
    be wrong by a factor (as the JAX package raises for a mesh without
    host weights, ``encoders.py:336-340``)."""
    want = (0, 1) if group is None \
        else (dist.get_rank(group), dist.get_world_size(group))
    if tuple(graph.shard) != want:
        raise ValueError(f"a layer that sums shard {want} got a graph of "
                         f"shard {tuple(graph.shard)}: build it with "
                         f"shard={want}, and sum a shard with its mesh's "
                         f"group")
