"""The meshes' collectives over a ``torch.distributed`` process group,
which the models, the sharded steps and the train loop call (the JAX
package's ``psum`` / ``pmean`` / ``all_gather`` / ``all_to_all`` inside
its mesh and vertex-sharded steps).

Every all-reduce and all-gather, forward and backward, is counted in
``all_reduce_sum.calls`` and ``all_reduce_sum.bytes``; every all-to-all
of the vertex-sharded halo exchange, forward and backward, in
``halo_exchange.calls`` and ``halo_exchange.bytes`` (the bytes each rank
sends, its own slab included).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..ops.gather import add_by_id
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
    tensor, gloo into the views of its blocks. Differentiable: the
    backward all-reduces the cotangent and keeps this rank's rows (JAX's
    transpose of a tiled ``all_gather``)."""
    return _AllGatherRows.apply(x, group)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _count(out)
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        dist.all_gather(list(out.chunk(n)), x, group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce(grad.clone(memory_format=torch.contiguous_format),
                            ctx.group)
        rank = dist.get_rank(ctx.group)
        return total[rank * ctx.rows:(rank + 1) * ctx.rows], None


def _all_to_all(x: torch.Tensor, group, async_op: bool = False):
    """(out, work): block q of ``x`` ([n * h, d], contiguous) to rank q,
    and block q of ``out`` from rank q, by one ``all_to_all_single`` with
    equal splits, counted; ``work`` is the pending exchange under
    ``async_op`` (``out`` holds the rows once ``work.wait()`` returns),
    else None. Gloo takes CUDA tensors for it (ranks that share a card),
    as NCCL does."""
    halo_exchange.calls += 1
    halo_exchange.bytes += x.numel() * x.element_size()
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x, group=group, async_op=async_op)
    return out, work


class _HaloExchange(torch.autograd.Function):
    """Forward: the rows ``send_idx`` [n, h] of ``feats`` [rows, d] (block
    q the rows this rank ships to rank q), one all-to-all, [n * h, d]
    (block q the rows rank q shipped here), with ``feats`` appended where
    ``with_local``; with a list ``flights`` the all-to-all is issued
    without waiting and (work, the rows sent) appended to it. Backward:
    the remote blocks' cotangent goes home by the same all-to-all, then
    is summed by id into this rank's rows (``gather.add_by_id``: kernel 3
    on the card, a fixed order), plus the local slab's cotangent."""

    @staticmethod
    def forward(ctx, feats, send_idx, group, with_local, flights):
        ctx.group, ctx.with_local = group, with_local
        ctx.save_for_backward(send_idx)
        ctx.rows = feats.shape[0]
        sent = feats[send_idx.reshape(-1).long()]
        remote, work = _all_to_all(sent, group, flights is not None)
        if flights is not None:
            flights.append((work, sent))
        return torch.cat([remote, feats]) if with_local else remote

    @staticmethod
    def backward(ctx, grad):
        send_idx, = ctx.saved_tensors
        n_remote = send_idx.numel()
        back, _ = _all_to_all(grad[:n_remote].contiguous(), ctx.group)
        d_feats = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        add_by_id(d_feats, send_idx.reshape(-1), back)
        if ctx.with_local:
            d_feats = d_feats + grad[n_remote:]
        return d_feats, None, None, None, None


def halo_exchange(feats: torch.Tensor, send_idx: torch.Tensor,
                  group) -> torch.Tensor:
    """The targeted halo exchange (JAX ``vertex_sharded.py:221-226``):
    [n * h + rows, d], the rows this rank asked each owner q for (block q,
    h rows), then its own ``feats`` [rows, d] (own-shard reads never ride
    the wire). ``send_idx`` [n, h]: this rank's rows that rank q asked for,
    in block q (``vertex_sharded.build_halo``'s ``send_idx[rank]``).
    Differentiable in ``feats``."""
    return _HaloExchange.apply(feats, send_idx, group, True, None)


def halo_exchange_remote(feats: torch.Tensor, send_idx: torch.Tensor,
                         group) -> Callable[[], torch.Tensor]:
    """The wire half of ``halo_exchange`` (JAX
    ``vertex_sharded.py:229-237``), issued without waiting: returns a
    function that waits for the exchange and gives its [n * h, d] rows, so
    that the overlapped schedule computes the local-source messages while
    the rows travel. Differentiable in ``feats``; the backward's
    all-to-all waits."""
    flights = []
    remote = _HaloExchange.apply(feats, send_idx, group, False, flights)
    flight = flights.pop()  # (work, the rows sent: alive until it ends)

    def arrive() -> torch.Tensor:
        flight[0].wait()
        return remote
    return arrive


halo_exchange.calls = 0
halo_exchange.bytes = 0


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
