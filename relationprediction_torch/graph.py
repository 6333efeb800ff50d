"""Typed directed edge graph with one CSR layout per aggregation direction.

Counterpart of ``relationprediction_tpu/graph.py``. The reference's
``forward_incidence_matrix('global') @ messages`` is a sparse softmax of ones
per receiver row (== 1/in-degree) followed by SpMM; here, as there, the
1/degree weights are computed once on the host (``_host_norm``), and so
are the other normalizations of ``degree_normalization``
(``graph.py:476-520`` there): 'local' (1 / the count of the edge's
(target, relation) pair) and 'none' (unit weights).

Where the JAX package lays the edges out in TPU slots (row blocks of 256,
chunks of 512, phantom rows and a finishing segment-sum), the port keeps one
CSR per direction, by target: ``row_ptr [V+1]`` then ``src``, ``rel`` and
``w`` per edge, sorted by (target, relation) within each row. One CUDA
block owns one target row, so the sum needs no atomics and no second pass
(ops/staircase2.py).

The backward of a direction needs d(features), a sum over each edge's
*source*: the same kernel on a "twin" CSR by source. A direction's twin has
the opposite direction's rows and edge order but this direction's weights
(``staircase2.build_staircase2_pair``), so it shares ``row_ptr``, ``src``
and ``rel`` with the opposite CSR and carries only its own ``w``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch


# The layout's per-entry tensors, in constructor order.
_CSR_TENSORS = ("row_ptr", "src", "rel", "w")


@dataclass(frozen=True)
class CsrLayout:
    """One direction's edges grouped by target row.

    row_ptr: int32 [n_rows + 1]; row v's edges are [row_ptr[v], row_ptr[v+1]).
    src:     int32 [E] row of the gathered table whose features feed each
             edge.
    rel:     int32 [E] relation id; ascending within each row.
    w:       float32 [E] aggregation weight.
    n_sources: rows of the table that ``src`` indexes, where it is not
             n_rows: a rectangular layout, such as a vertex shard's, which
             sums into its ``rows_per`` owned rows from a halo buffer of
             another length (parallel/vertex_sharded.py); None for a
             square layout (``source_rows`` is then n_rows).
    """

    row_ptr: torch.Tensor
    src: torch.Tensor
    rel: torch.Tensor
    w: torch.Tensor
    n_sources: Optional[int] = None

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]

    @property
    def source_rows(self) -> int:
        """Rows of the table the layout gathers from."""
        return self.n_rows if self.n_sources is None else self.n_sources

    def map(self, fn) -> "CsrLayout":
        """The same layout with ``fn`` applied to each of its tensors."""
        return replace(self, **{k: fn(getattr(self, k))
                                for k in _CSR_TENSORS})

    def to(self, device) -> "CsrLayout":
        return self.map(lambda t: t.to(device))

    def tensors(self) -> list:
        return [getattr(self, k) for k in _CSR_TENSORS]


def build_csr(sources: np.ndarray, relations: np.ndarray,
              targets: np.ndarray, weights: np.ndarray,
              n_vertices: int, n_sources: Optional[int] = None) -> tuple:
    """CSR by target of the real edges (weight != 0 and target < V), and
    the order of its entries: ``(layout, order)``, where CSR entry k is
    input edge ``order[k]`` (int64 numpy).

    Edges with weight 0 or a target at or beyond ``n_vertices`` are padding
    and dropped, as the TPU slot layout drops them
    (``staircase2.build_staircase2_layout``). ``n_sources``: the rows of
    the table the sources index, n_vertices where None; a real edge's
    source must lie in [0, n_sources). The kernels check no index on the
    device, so this is the guard against a read out of bounds.
    """
    sources = np.asarray(sources, dtype=np.int64)
    relations = np.asarray(relations, dtype=np.int64)
    targets = np.asarray(targets, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float32)
    n_src = n_vertices if n_sources is None else int(n_sources)
    real = np.nonzero((targets < n_vertices) & (weights != 0.0))[0]
    if real.size and (sources[real].min() < 0 or targets[real].min() < 0
                      or sources[real].max() >= n_src
                      or relations[real].min() < 0):
        raise ValueError("build_csr: a real edge has a source outside "
                         f"[0, {n_src}), a negative target or a negative "
                         "relation")
    order = real[np.lexsort((relations[real], targets[real]))]
    counts = np.bincount(targets[order], minlength=n_vertices)
    row_ptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if row_ptr[-1] >= 2 ** 31:
        raise ValueError("edge count overflows the int32 CSR")
    layout = CsrLayout(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
        src=torch.from_numpy(sources[order].astype(np.int32)),
        rel=torch.from_numpy(relations[order].astype(np.int32)),
        w=torch.from_numpy(weights[order]),
        n_sources=None if n_sources is None else n_src)
    return layout, order


@dataclass(frozen=True)
class GraphBatch:
    """The CSR layouts of one message graph.

    fwd: CSR by receiver, fed by senders, weighted 1/in-degree of the
      receiver (the JAX package's ``fwd_norm``).
    bwd: CSR by sender, fed by receivers, weighted 1/out-degree of the
      sender (``bwd_norm``).
    fwd_twin: fwd's backward layout: bwd's rows and edges with fwd's
      weights. bwd_twin: fwd's rows and edges with bwd's weights.
    fwd_order / bwd_order: int64 [E], the input edge (row of the triples
      the graph was built from) of each fwd / bwd CSR entry; the
      stored-message layer indexes its per-edge caches through them.
    normalization: the weights' rule ('global', 'local' or 'none'); bf16
      message precision applies to 'global' graphs only, as in the JAX
      package, whose other normalizations take its f32 segment sum.
    shard: (rank, n): the graph holds the rank-th of n contiguous blocks
      of the input edges, with the whole input's weights (``shard_edges``);
      (0, 1) is the whole graph. An edge-partitioned layer sums a shard
      and all-reduces the partial [V, d] sums (parallel/mesh.py).
    """

    fwd: CsrLayout
    bwd: CsrLayout
    fwd_twin: CsrLayout
    bwd_twin: CsrLayout
    fwd_order: torch.Tensor
    bwd_order: torch.Tensor
    n_vertices: int
    n_relations: int
    normalization: str = "global"
    shard: tuple = (0, 1)

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """The same graph on ``device``; the twins keep sharing their
        index arrays with the opposite layout there. ``non_blocking``: an
        asynchronous copy from pinned host memory, ordered on the current
        stream."""
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """The same graph in page-locked host memory, for an asynchronous
        copy to the card."""
        return self._map(lambda t: t.pin_memory())

    def clone(self) -> "GraphBatch":
        """A copy of the graph in new memory on its device, its twins
        sharing their index arrays as here."""
        return self._map(torch.clone)

    def _map(self, fn) -> "GraphBatch":
        fwd, bwd = self.fwd.map(fn), self.bwd.map(fn)
        return GraphBatch(fwd, bwd, replace(bwd, w=fn(self.fwd_twin.w)),
                          replace(fwd, w=fn(self.bwd_twin.w)),
                          fn(self.fwd_order), fn(self.bwd_order),
                          self.n_vertices, self.n_relations,
                          self.normalization, self.shard)

    def tensors(self) -> list:
        """Every distinct tensor of the graph (the twins' index arrays are
        the opposite layout's)."""
        return (self.fwd.tensors() + self.bwd.tensors()
                + [self.fwd_twin.w, self.bwd_twin.w, self.fwd_order,
                   self.bwd_order])

    def signature(self) -> tuple:
        """The sizes of the graph that are no tensor's shape."""
        return (self.n_vertices, self.n_relations, self.normalization,
                self.shard, tuple(lay.n_sources for lay in (
                    self.fwd, self.bwd, self.fwd_twin, self.bwd_twin)))


NORMALIZATIONS = ("global", "local", "none")


def shard_edges(n_edges: int, shard: tuple) -> slice:
    """The input edges of shard ``(rank, n)``: the rank-th of n equal
    contiguous blocks of the edges padded to a multiple of lcm(8, n), as
    the JAX package pads and splits its edge axis over a mesh
    (``shard_align``, ``engine.py:141``); the padding holds no edge."""
    rank, n = shard
    if not 0 <= rank < n:
        raise ValueError(f"shard {shard}: rank outside [0, {n})")
    per = -(-n_edges // int(np.lcm(8, n))) * int(np.lcm(8, n)) // n
    return slice(min(rank * per, n_edges), min((rank + 1) * per, n_edges))


def build_graph_batch(triples: np.ndarray, n_vertices: int, n_relations: int,
                      normalization: str = "global",
                      shard: tuple = (0, 1)) -> GraphBatch:
    """Host-side construction of a GraphBatch (on the CPU) from an [N, 3]
    (s, r, o) array; ``GraphBatch.to`` moves it to the card.

    ``normalization`` sets every layout's weights, per direction (the
    target is the receiver forward, the sender backward): 'global' 1 /
    degree of the target, 'local' 1 / count of the (target, relation)
    pair, 'none' 1. They are counted over all of ``triples``; ``shard``
    (rank, n) then keeps that rank's block of the edges (``shard_edges``)
    in CSRs over all V rows, so that the shards' sums add up to the whole
    graph's (a degree counted over a shard would not). The orders index
    ``triples``.
    """
    if normalization not in NORMALIZATIONS:
        raise ValueError(f"unknown normalization {normalization!r}")
    triples = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
    senders, relations, receivers = triples.T
    if len(triples) and relations.max() >= n_relations:
        raise ValueError(f"relation id >= n_relations={n_relations}")
    fwd_w = _host_norm(receivers, relations, n_vertices, n_relations,
                       normalization)
    bwd_w = _host_norm(senders, relations, n_vertices, n_relations,
                       normalization)
    block = shard_edges(len(triples), shard)
    # Every edge is real here (weights > 0, vertices checked), so both
    # CSRs hold the same edges and each order permutes all of them.
    fwd, fwd_order = build_csr(senders[block], relations[block],
                               receivers[block], fwd_w[block], n_vertices)
    bwd, bwd_order = build_csr(receivers[block], relations[block],
                               senders[block], bwd_w[block], n_vertices)
    fwd_order += block.start
    bwd_order += block.start
    return GraphBatch(
        fwd=fwd, bwd=bwd,
        fwd_twin=replace(bwd, w=torch.from_numpy(fwd_w[bwd_order])),
        bwd_twin=replace(fwd, w=torch.from_numpy(bwd_w[fwd_order])),
        fwd_order=torch.from_numpy(fwd_order),
        bwd_order=torch.from_numpy(bwd_order),
        n_vertices=int(n_vertices),
        n_relations=int(n_relations),
        normalization=normalization,
        shard=tuple(shard))


def _host_norm(targets: np.ndarray, relations: np.ndarray, n_vertices: int,
               n_relations: int, normalization: str) -> np.ndarray:
    """Per-edge weights of one direction (``relationprediction_tpu/
    graph.py:degree_normalization``): 'global' 1 / degree of the edge's
    target, 'local' 1 / count of its (target, relation) pair, 'none' 1."""
    if normalization == "none":
        return np.ones(len(targets), dtype=np.float32)
    if normalization == "global":
        key, n_keys = targets, n_vertices
    else:
        key = targets * n_relations + relations
        n_keys = n_vertices * n_relations
    count = np.bincount(key, minlength=n_keys)
    return (1.0 / np.maximum(count[key], 1.0)).astype(np.float32)


@dataclass(frozen=True)
class CompGCNGraph:
    """The message graph of a CompGCN layer (Vashishth et al. 2020): each
    train triple (s, r, o) twice, and every entity's self-loop apart.

    The official code (github.com/malllabiisc/CompGCN) stacks the edges
    (s, o) of type r and then (o, s) of type r + R, sends each message from
    the pair's second entity and sums it into its first, and weights each
    half's edges by ``compute_norm``: 1 / sqrt(deg(target) deg(source)),
    both degrees counted over the half's targets, 0 where a source is no
    target of that half. So ``inward`` sums into s the messages from o with
    relation r, and ``outward`` into o those from s with relation r + R.
    An edge of weight 0 adds nothing and is left out (``build_csr``).

    inward / outward: the two halves' CSRs by target (weights the norms).
    src_ids / rel_ids: int64 [E_in + E_out], the inward then the outward
    entries' source entities and relation ids (0 .. 2R - 1): the rows a
    step gathers. by_source / by_relation: (row_ptr int32, order int32),
    the CSR by id of those entries over the V entities and the 2R
    relation rows, which sums the gathers' gradients by id
    (``ops.gather.take_rows``).
    """

    inward: CsrLayout
    outward: CsrLayout
    src_ids: torch.Tensor
    rel_ids: torch.Tensor
    by_source: tuple
    by_relation: tuple
    n_vertices: int
    n_relations: int

    @property
    def n_edges(self) -> int:
        """The message edges of both halves (self-loops not counted)."""
        return int(self.src_ids.shape[0])

    def _map(self, fn) -> "CompGCNGraph":
        return CompGCNGraph(self.inward.map(fn), self.outward.map(fn),
                            fn(self.src_ids), fn(self.rel_ids),
                            tuple(fn(t) for t in self.by_source),
                            tuple(fn(t) for t in self.by_relation),
                            self.n_vertices, self.n_relations)

    def to(self, device, non_blocking: bool = False) -> "CompGCNGraph":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "CompGCNGraph":
        return self._map(lambda t: t.pin_memory())

    def clone(self) -> "CompGCNGraph":
        return self._map(torch.clone)

    def tensors(self) -> list:
        return (self.inward.tensors() + self.outward.tensors()
                + [self.src_ids, self.rel_ids, *self.by_source,
                   *self.by_relation])

    def signature(self) -> tuple:
        return (self.n_vertices, self.n_relations)


def compgcn_norm(targets: np.ndarray, sources: np.ndarray,
                 n_vertices: int) -> np.ndarray:
    """The official ``compute_norm`` of one half: deg^-1/2 of the target
    times deg^-1/2 of the source, deg counted over the half's targets and
    its infinite inverses (degree 0) set to 0."""
    deg = np.bincount(targets, minlength=n_vertices).astype(np.float32)
    inv = np.zeros_like(deg)
    np.divide(1.0, np.sqrt(deg), out=inv, where=deg > 0)
    return (inv[targets] * inv[sources]).astype(np.float32)


def _id_csr(ids: np.ndarray, n_ids: int) -> tuple:
    order = np.argsort(ids, kind="stable")
    row_ptr = np.searchsorted(ids[order], np.arange(n_ids + 1))
    return (torch.from_numpy(row_ptr.astype(np.int32)),
            torch.from_numpy(order.astype(np.int32)))


def build_compgcn_graph(triples: np.ndarray, n_vertices: int,
                        n_relations: int) -> CompGCNGraph:
    """The ``CompGCNGraph`` of an [N, 3] (s, r, o) array, on the host."""
    t = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
    s, r, o = t.T
    if len(t) and (r.max() >= n_relations or r.min() < 0):
        raise ValueError(f"relation id outside [0, {n_relations})")
    inward, _ = build_csr(o, r, s, compgcn_norm(s, o, n_vertices),
                          n_vertices)
    outward, _ = build_csr(s, r + n_relations, o,
                           compgcn_norm(o, s, n_vertices), n_vertices)
    src = torch.cat([inward.src, outward.src]).long()
    rel = torch.cat([inward.rel, outward.rel]).long()
    return CompGCNGraph(inward, outward, src, rel,
                        _id_csr(src.numpy(), n_vertices),
                        _id_csr(rel.numpy(), 2 * n_relations),
                        int(n_vertices), int(n_relations))
