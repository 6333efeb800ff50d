"""Exact re-implementations of the reference's three dataset builders.

The reference ships three one-off scripts that construct derived datasets
from FB15k / FB15k-237 (``code/tools/make_degree_dataset.py``,
``make_single_label_dataset.py``, ``make_split_dataset.py``). Each hardcodes
its source paths and thresholds; this module reproduces their *sampling
semantics* exactly, parameterized and seedable, behind one CLI:

  * ``degree``       — frontier-expansion subgraph growth that SKIPS hub
    entities whose incident-edge count exceeds a cap (200 in the
    reference), grown until > 30000 edges, then 500 valid + 500 test edges
    carved out at random (``make_degree_dataset.py:37-80``).
  * ``single-label`` — the same growth with cap 500 until > 500 edges,
    then a synthetic one-relation dataset of SECOND-ORDER edges: each
    source edge is kept with p=0.8 into a directed adjacency, and
    (k, 2nd_order_edge, e) is emitted for every 2-hop pair
    (``make_single_label_dataset.py:37-110``).
  * ``split``        — entity-partition splitting: repeatedly pick a random
    entity and move ALL of its incident edges into the split until the
    split reaches ``max_edges``; applied twice to carve valid then test
    (10000 each in the reference) so split entities' edge sets never
    straddle the boundary (``make_split_dataset.py:70-112``).

All functions operate on [N, 3] arrays of *name* strings, like the
reference (ids never enter the construction).

The port's copy of ``relationprediction_tpu/tools/make_datasets.py``.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np

from ..data import io


def _incidence(triples: np.ndarray):
    """edge-index lists per entity name: (as-subject, as-object) dicts."""
    by_sub: dict = {}
    by_obj: dict = {}
    for i in range(triples.shape[0]):
        by_sub.setdefault(triples[i, 0], []).append(i)
        by_obj.setdefault(triples[i, 2], []).append(i)
    return by_sub, by_obj


def grow_subgraph(triples: np.ndarray, n_target_edges: int,
                  rng: np.random.Generator,
                  degree_cap: Optional[int] = None,
                  start_entity: Optional[str] = None) -> np.ndarray:
    """Reference ``shrink_graph`` semantics (make_degree_dataset.py:37-66):

    keep a candidate-entity pool; each round draw one entity uniformly,
    remove it from the pool, and — unless its incident-edge count exceeds
    ``degree_cap`` — absorb all its incident edges and add its neighbors
    to the pool. Stop once the edge set EXCEEDS ``n_target_edges``.
    Returns sorted unique edge indices into ``triples``.
    """
    by_sub, by_obj = _incidence(triples)
    entities = np.unique(np.concatenate([triples[:, 0], triples[:, 2]]))
    if start_entity is None:
        start_entity = entities[rng.integers(len(entities))]
    pool = {start_entity}
    # Entities already expanded (or skipped as hubs) contribute nothing on a
    # re-pick; tracking them guarantees termination where the reference's
    # recursive version would blow the stack once the reachable component is
    # exhausted (make_degree_dataset.py:37-66 has no such guard).
    spent: set = set()
    picked = np.zeros(triples.shape[0], dtype=bool)
    n_picked = 0

    while n_picked <= n_target_edges:
        live = pool - spent
        if not live:  # exhausted the component before reaching the target
            break
        # uniform draw from the pool (reference: random.choice on an array)
        pool_arr = sorted(live)
        entity = pool_arr[rng.integers(len(pool_arr))]
        pool.discard(entity)
        spent.add(entity)

        inc = by_sub.get(entity, []) + by_obj.get(entity, [])
        if degree_cap is not None and len(inc) > degree_cap:
            continue  # hub: drop from pool, absorb nothing

        neighbors = np.concatenate([
            triples[by_sub.get(entity, []), 2],
            triples[by_obj.get(entity, []), 0]]) if inc else np.array([])
        for i in inc:
            if not picked[i]:
                picked[i] = True
                n_picked += 1
        pool.update(neighbors.tolist())
        pool.discard(entity)  # reference removes the chosen entity again

    return np.flatnonzero(picked)


def carve(edges: np.ndarray, n: int, rng: np.random.Generator
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Random without-replacement split: returns (remaining, carved) —
    the reference's np.random.choice + np.delete pair."""
    sample = rng.choice(edges.shape[0], size=n, replace=False)
    carved = edges[sample]
    remaining = np.delete(edges, sample, axis=0)
    return remaining, carved


def second_order_dataset(subgraph: np.ndarray, rng: np.random.Generator,
                         keep_prob: float = 0.8,
                         relation_name: str = "2nd_order_edge") -> np.ndarray:
    """make_single_label_dataset.py:72-103 — directed adjacency thinned at
    ``keep_prob``, squared, emitted as a one-relation triple set."""
    adj: dict = {}
    for i in range(subgraph.shape[0]):
        s, o = subgraph[i, 0], subgraph[i, 2]
        adj.setdefault(s, [])
        adj.setdefault(o, [])
        if rng.binomial(1, keep_prob):
            adj[s].append(o)
    adj = {k: np.unique(v) for k, v in adj.items()}

    out = []
    for k in adj:
        second = np.unique(np.concatenate(
            [adj[e] for e in adj[k]] or [np.array([], dtype=object)]))
        for e in second:
            out.append([k, relation_name, e])
    return np.array(out, dtype=object).reshape(-1, 3)


def split_by_entities(triples: np.ndarray, rng: np.random.Generator,
                      max_edges: int) -> Tuple[np.ndarray, np.ndarray]:
    """make_split_dataset.py:70-105 — move whole entities' edge sets into
    the split until it holds >= max_edges edges. Returns
    (remaining_triples, split_triples)."""
    incident = {}
    for i in range(triples.shape[0]):
        e1, e2 = triples[i, 0], triples[i, 2]
        incident.setdefault(e1, []).append(i)
        if e1 != e2:
            incident.setdefault(e2, []).append(i)

    pool = sorted(incident.keys())
    picked = np.zeros(triples.shape[0], dtype=bool)
    n_picked = 0
    while n_picked < max_edges and pool:
        j = rng.integers(len(pool))
        entity = pool.pop(j)
        for i in incident[entity]:
            if not picked[i]:
                picked[i] = True
                n_picked += 1

    split_idx = np.flatnonzero(picked)
    remaining = np.delete(triples, split_idx, axis=0)
    return remaining, triples[split_idx]


def _write_splits(folder: str, train: np.ndarray, valid: np.ndarray,
                  test: np.ndarray) -> None:
    os.makedirs(folder, exist_ok=True)
    for name, arr in (("train", train), ("valid", valid), ("test", test)):
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            for row in arr:
                f.write("\t".join(str(x) for x in row) + "\n")


def build_degree_dataset(source: np.ndarray, rng: np.random.Generator,
                         target_edges: int = 30000, degree_cap: int = 200,
                         n_valid: int = 500, n_test: int = 500):
    idx = grow_subgraph(source, target_edges, rng, degree_cap=degree_cap)
    train = source[idx]
    train, valid = carve(train, n_valid, rng)
    train, test = carve(train, n_test, rng)
    return train, valid, test


def build_single_label_dataset(source: np.ndarray, rng: np.random.Generator,
                               target_edges: int = 500, degree_cap: int = 500,
                               keep_prob: float = 0.8,
                               n_valid: int = 500, n_test: int = 500):
    idx = grow_subgraph(source, target_edges, rng, degree_cap=degree_cap)
    train = second_order_dataset(source[idx], rng, keep_prob=keep_prob)
    train, valid = carve(train, n_valid, rng)
    train, test = carve(train, n_test, rng)
    return train, valid, test


def build_split_dataset(source: np.ndarray, rng: np.random.Generator,
                        n_valid: int = 10000, n_test: int = 10000):
    train, valid = split_by_entities(source, rng, max_edges=n_valid)
    train, test = split_by_entities(train, rng, max_edges=n_test)
    return train, valid, test


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Construct derived datasets (reference tool parity).")
    p.add_argument("--kind", required=True,
                   choices=["degree", "single-label", "split"])
    p.add_argument("--source", required=True,
                   help="source dataset folder (train.txt inside)")
    p.add_argument("--folder", required=True, help="output dataset folder")
    p.add_argument("--edges", type=int, default=None,
                   help="subgraph growth target (degree: 30000, "
                        "single-label: 500)")
    p.add_argument("--valid", type=int, default=None)
    p.add_argument("--test", type=int, default=None)
    p.add_argument("--degree-cap", type=int, default=None)
    p.add_argument("--keep-prob", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    src = np.array(io.read_triplets(os.path.join(args.source, "train.txt")),
                   dtype=object)
    rng = np.random.default_rng(args.seed)

    def arg(value, default):
        return value if value is not None else default

    if args.kind == "degree":
        train, valid, test = build_degree_dataset(
            src, rng, target_edges=arg(args.edges, 30000),
            degree_cap=arg(args.degree_cap, 200),
            n_valid=arg(args.valid, 500), n_test=arg(args.test, 500))
    elif args.kind == "single-label":
        train, valid, test = build_single_label_dataset(
            src, rng, target_edges=arg(args.edges, 500),
            degree_cap=arg(args.degree_cap, 500), keep_prob=args.keep_prob,
            n_valid=arg(args.valid, 500), n_test=arg(args.test, 500))
    else:
        train, valid, test = build_split_dataset(
            src, rng, n_valid=arg(args.valid, 10000),
            n_test=arg(args.test, 10000))

    _write_splits(args.folder, train, valid, test)
    print(f"{args.folder}: train={train.shape[0]} valid={valid.shape[0]} "
          f"test={test.shape[0]}")


if __name__ == "__main__":
    main()
