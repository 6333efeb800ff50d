"""Host-side samplers: the binomial negative sampler of the host-tiled
batch, neighbourhood-expansion subgraph sampling, uniform edge sampling and
the message-graph edge split.

A copy of ``relationprediction_tpu/sampling.py:17-52`` (``NegativeSampler``,
``transform`` only) and ``:122-255``: numpy on the host, so the same
``np.random.Generator`` state gives the same ids as the JAX package, and
the C++ sampler (``native/``) the same ids for the same seed. By default
the train step draws its negatives on the device
(``training/device_sampling.py``); ``BatchPipeline(device_negatives=False)``
tiles them here. The filtered ``transform_exclusive`` and
``RelationFilter``, which no shipped setting uses, are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class NegativeSampler:
    """Uniform binomial corruption (``auxilliaries.py:13-33``):
    ``transform`` tiles the batch (rate+1) times, labels the first copy
    positive, and for each negative a fair coin picks the subject or the
    object, which a uniform entity replaces, without filtering known
    positives (the reference's default). Draws from ``rng``, which the
    batch pipeline shares (``engine.py:98-99``)."""

    def __init__(self, negative_sample_rate: int, n_entities: int,
                 rng: np.random.Generator):
        self.negative_sample_rate = int(negative_sample_rate)
        self.n_entities = int(n_entities)
        self.rng = rng

    def transform(self, triples: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(tiled triples [(rate+1) n, 3] int32, labels [(rate+1) n]
        float32): row j*n + i is positive i's copy j."""
        triples = np.asarray(triples, dtype=np.int32).reshape(-1, 3)
        n = triples.shape[0]
        rate = self.negative_sample_rate
        n_neg = n * rate
        out = np.tile(triples, (rate + 1, 1)).astype(np.int32)
        labels = np.zeros(n * (rate + 1), dtype=np.float32)
        labels[:n] = 1.0
        corrupt_object = self.rng.random(n_neg) < 0.5
        values = self.rng.integers(0, self.n_entities, size=n_neg,
                                   dtype=np.int64).astype(np.int32)
        neg = out[n:]
        neg[corrupt_object, 2] = values[corrupt_object]
        neg[~corrupt_object, 0] = values[~corrupt_object]
        return out, labels


class AdjacencyIndex:
    """CSR-style adjacency over undirected incidence, equivalent to the
    driver's ``adj_list``/``degrees`` build (``train.py:133-139``): for each
    vertex, the (edge_id, other_vertex) pairs of its incident edges."""

    def __init__(self, triples: np.ndarray, n_entities: int):
        triples = np.asarray(triples, dtype=np.int64)
        n_edges = triples.shape[0]
        ends = np.concatenate([triples[:, 0], triples[:, 2]])
        others = np.concatenate([triples[:, 2], triples[:, 0]])
        edge_ids = np.concatenate([np.arange(n_edges), np.arange(n_edges)])

        order = np.argsort(ends, kind="stable")
        self.sorted_edges = edge_ids[order].astype(np.int32)
        self.sorted_others = others[order].astype(np.int32)
        self.degrees = np.bincount(ends, minlength=n_entities).astype(np.int64)
        self.offsets = np.zeros(n_entities + 1, dtype=np.int64)
        np.cumsum(self.degrees, out=self.offsets[1:])
        self.n_entities = n_entities
        self.n_edges = n_edges

    def incident(self, vertex: int) -> Tuple[np.ndarray, np.ndarray]:
        b, e = self.offsets[vertex], self.offsets[vertex + 1]
        return self.sorted_edges[b:e], self.sorted_others[b:e]


def sample_edge_neighborhood(adj: AdjacencyIndex, sample_size: int,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
    """Degree-weighted neighborhood-expansion edge sampling, the same
    algorithm as ``train.py:161-198``: grow a vertex frontier, each step
    picking a seen vertex with probability proportional to its remaining
    degree budget, then an unpicked incident edge of that vertex.

    Returns sample_size edge indices into the training triple array.

    This numpy version keeps the exact sequential semantics; the O(V) weight
    renormalization per step is replaced by incremental bookkeeping so it is
    ~two orders of magnitude faster than the reference loop. A C++
    implementation (native/sampler.cpp) is used when available.
    """
    rng = rng if rng is not None else np.random.default_rng()
    n_vertices = adj.n_entities

    sample_counts = adj.degrees.astype(np.float64).copy()
    seen = np.zeros(n_vertices, dtype=bool)
    picked = np.zeros(adj.n_edges, dtype=bool)
    edges = np.zeros(sample_size, dtype=np.int32)

    # Incremental weight bookkeeping: weights = sample_counts * seen.
    weights = np.zeros(n_vertices, dtype=np.float64)
    total = 0.0

    def bump(v: int, delta: float) -> None:
        nonlocal total
        if seen[v]:
            weights[v] += delta
            total += delta

    def mark_seen(v: int) -> None:
        nonlocal total
        if not seen[v]:
            seen[v] = True
            weights[v] = sample_counts[v]
            total += weights[v]

    for i in range(sample_size):
        if total <= 0:
            # Cold start / exhausted frontier: uniform over vertices with
            # remaining degree (train.py:169-171).
            candidates = np.flatnonzero(sample_counts > 0)
            chosen_vertex = int(rng.choice(candidates))
        else:
            # Categorical draw proportional to weights without forming the
            # full probability vector: inverse-CDF over nonzero support.
            u = rng.random() * total
            nz = np.flatnonzero(weights > 0)
            cdf = np.cumsum(weights[nz])
            chosen_vertex = int(nz[np.searchsorted(cdf, u, side="right").clip(0, len(nz) - 1)])

        mark_seen(chosen_vertex)

        inc_edges, inc_others = adj.incident(chosen_vertex)
        # Rejection-sample an unpicked incident edge (train.py:181-187).
        unpicked = np.flatnonzero(~picked[inc_edges])
        j = int(rng.choice(unpicked))
        edge_number = int(inc_edges[j])
        other_vertex = int(inc_others[j])

        edges[i] = edge_number
        picked[edge_number] = True
        bump(chosen_vertex, -1.0)
        sample_counts[chosen_vertex] -= 1
        bump(other_vertex, -1.0)
        sample_counts[other_vertex] -= 1
        mark_seen(other_vertex)

    return edges


def sample_edge_neighborhood_fast(adj: AdjacencyIndex, sample_size: int,
                                  rng: Optional[np.random.Generator] = None
                                  ) -> np.ndarray:
    """Neighborhood sampling through the C++ sampler when a g++ is
    found (same distribution, its own RNG stream seeded from ``rng``),
    numpy otherwise."""
    rng = rng if rng is not None else np.random.default_rng()
    from . import native
    if native.available():
        seed = int(rng.integers(0, 2 ** 63 - 1))
        return native.sample_edge_neighborhood(adj, sample_size, seed)
    return sample_edge_neighborhood(adj, sample_size, rng)


def sample_uniform_edges(n_edges: int, sample_size: int,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """Fast-path alternative: uniform edge sampling without replacement.
    Distributionally different from neighborhood expansion but much cheaper;
    offered as a config switch for throughput-bound runs."""
    rng = rng if rng is not None else np.random.default_rng()
    return rng.choice(n_edges, size=min(sample_size, n_edges),
                      replace=False).astype(np.int32)


def graph_split(graph_batch_ids: np.ndarray, split_size: float,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The 'permanent edge dropout' split (``train.py:235-238``): keep a
    random ``split_size`` fraction of the sampled edges as the
    message-passing graph. NOTE the reference samples from graph_batch_ids
    *with multiplicity semantics of np.random.choice over the id values*,
    i.e. ids, not positions; we preserve that."""
    rng = rng if rng is not None else np.random.default_rng()
    n = int(split_size * len(graph_batch_ids))
    return rng.choice(graph_batch_ids, size=n, replace=False).astype(np.int32)


def draw_subgraph(train: np.ndarray, adj: AdjacencyIndex, batch_size: int,
                  split_size: float, sampler: str,
                  rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(batch edge ids, message-graph edge ids) into ``train``, the batch
    pipelines' one draw (``engine.py:126-138``,
    ``vertex_sharded.py:1016-1043``): every edge where ``batch_size`` covers
    the train set, else a 'neighborhood' or 'uniform' sample of ``batch_size``
    edges, then its ``graph_split`` of ``split_size``, all from ``rng``."""
    if batch_size >= len(train):
        batch_ids = np.arange(len(train), dtype=np.int32)
    elif sampler == "neighborhood":
        batch_ids = sample_edge_neighborhood_fast(adj, batch_size, rng)
    else:
        batch_ids = sample_uniform_edges(len(train), batch_size, rng)
    return batch_ids, graph_split(batch_ids, split_size, rng)
