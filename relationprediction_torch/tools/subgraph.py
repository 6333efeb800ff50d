"""Random-walk subgraph dataset construction.

Generalizes the reference's three dataset builders
(``code/tools/make_degree_dataset.py`` / ``make_split_dataset.py`` /
``make_single_label_dataset.py``): grow an edge set by repeatedly picking a
frontier entity and absorbing its incident edges (optionally skipping hub
vertices above a degree cap), then carve valid/test splits out of the
sampled edges.

    python -m relationprediction_torch.tools.subgraph \
        --source data/FB15k --folder data/FB15k-sub \
        --edges 30000 --valid 500 --test 500 [--max-degree 200]

The port's copy of ``relationprediction_tpu/tools/subgraph.py``.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from ..data import io


def shrink_graph(triples: np.ndarray, n_target_edges: int,
                 rng: np.random.Generator,
                 max_degree: Optional[int] = None) -> np.ndarray:
    """Frontier-expansion edge sampling: returns indices of the grown edge
    set (>= n_target_edges)."""
    n = triples.shape[0]
    picked = np.zeros(n, dtype=bool)
    n_picked = 0
    frontier = {int(rng.choice(np.unique(
        np.concatenate([triples[:, 0], triples[:, 2]]))))}
    visited = set()

    # Precompute incidence lists.
    by_sub: dict = {}
    by_obj: dict = {}
    for i, (s, _, o) in enumerate(triples):
        by_sub.setdefault(int(s), []).append(i)
        by_obj.setdefault(int(o), []).append(i)

    while n_picked < n_target_edges:
        if not frontier:
            # restart from a random unvisited entity
            frontier.add(int(rng.integers(0, triples[:, [0, 2]].max() + 1)))
        entity = frontier.pop()
        if entity in visited:
            continue
        visited.add(entity)
        inc = by_sub.get(entity, []) + by_obj.get(entity, [])
        if max_degree is not None and len(inc) > max_degree:
            continue  # skip hub vertices (make_degree_dataset.py behavior)
        for i in inc:
            if not picked[i]:
                picked[i] = True
                n_picked += 1
            s, _, o = triples[i]
            other = int(o) if int(s) == entity else int(s)
            if other not in visited:
                frontier.add(other)
    return np.flatnonzero(picked)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Make a subgraph dataset.")
    parser.add_argument("--source", required=True,
                        help="Source dataset directory.")
    parser.add_argument("--folder", required=True,
                        help="Output dataset directory.")
    parser.add_argument("--edges", type=int, default=30000)
    parser.add_argument("--valid", type=int, default=500)
    parser.add_argument("--test", type=int, default=500)
    parser.add_argument("--max-degree", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    name_triples = np.array(io.read_triplets(
        os.path.join(args.source, "train.txt")))
    # Work on name strings directly (the output files are name TSVs).
    ids = np.arange(len(name_triples))
    # Map names to ints for the sampler.
    ents = {n: i for i, n in enumerate(
        sorted(set(name_triples[:, 0]) | set(name_triples[:, 2])))}
    int_triples = np.stack([
        np.array([ents[s] for s in name_triples[:, 0]]),
        np.zeros(len(name_triples), dtype=np.int64),
        np.array([ents[o] for o in name_triples[:, 2]])], axis=1)

    edge_ids = shrink_graph(int_triples, args.edges, rng, args.max_degree)
    sampled = name_triples[edge_ids]
    rng.shuffle(sampled)

    valid = sampled[:args.valid]
    test = sampled[args.valid:args.valid + args.test]
    train = sampled[args.valid + args.test:]

    os.makedirs(args.folder, exist_ok=True)
    for split, rows in (("train", train), ("valid", valid), ("test", test)):
        with open(os.path.join(args.folder, f"{split}.txt"), "w") as f:
            for s, r, o in rows:
                f.write(f"{s}\t{r}\t{o}\n")

    # Regenerate dictionaries restricted to the subgraph.
    entities = sorted({t[0] for t in sampled} | {t[2] for t in sampled})
    relations = sorted({t[1] for t in sampled})
    io.write_dictionary(os.path.join(args.folder, "entities.dict"),
                        dict(enumerate(entities)))
    io.write_dictionary(os.path.join(args.folder, "relations.dict"),
                        dict(enumerate(relations)))
    print(f"{len(train)} train / {len(valid)} valid / {len(test)} test, "
          f"{len(entities)} entities, {len(relations)} relations")


if __name__ == "__main__":
    main()
