"""The cells' knowledge graphs: the published train counts, drawn from the
real graph's own held-out triples.

The train splits of FB15k-237 and WN18 are not in this repository;
their valid and test splits are, frozen here as ``samples/<name>.csv``
(integer ids of the datasets' dictionaries). A held-out split is a uniform
thinning of the whole graph, so it carries the train split's relation mix,
each relation's head and tail entities and the entities' degree skew. The
generator draws the published number of distinct train triples from them:

- each relation its share of the sample's triples (Good-Turing smoothed,
  as the entities below), exactly;
- its head from the relation's own heads in the sample, and its tail from
  its own tails, except with the relation's Good-Turing share of unseen
  entities (the heads, resp. tails, seen once for that relation over its
  sample count), where the entity comes from the whole graph's smoothed
  degree distribution: each sampled entity by its count, the missing mass
  (entities seen once over all endpoints) spread evenly over the entities
  the sample never names;
- draws repeated until each relation holds its share of distinct
  triples.

Every seed gets the same structure, the draw of ``structure_seed``, with
its entities and relations relabelled by a permutation drawn from the run's
seed: the same degree sequence, the same split and order of triples, so a
seed changes which vertex is which and not how much work a step holds. The
valid and test triples are the sample's own, relabelled alike.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

SAMPLES = Path(__file__).resolve().parent / "samples"


def load_sample(name: str) -> dict:
    """{"valid", "test"}: [n, 3] int64 (s, r, o) of ``samples/<name>.csv``."""
    rows = {"valid": [], "test": []}
    with open(SAMPLES / f"{name}.csv", newline="") as f:
        for row in csv.DictReader(f):
            rows[row["split"]].append((int(row["subject"]),
                                       int(row["relation"]),
                                       int(row["object"])))
    return {k: np.asarray(v, dtype=np.int64).reshape(-1, 3)
            for k, v in rows.items()}


def smoothed(counts: np.ndarray) -> np.ndarray:
    """Probabilities of the categories of ``counts``: each seen category
    by its count, with the Good-Turing missing mass (categories seen once
    over the total) spread evenly over the unseen ones."""
    counts = counts.astype(np.float64)
    total, unseen = counts.sum(), int((counts == 0).sum())
    missing = (counts == 1).sum() / total if unseen else 0.0
    return np.where(counts > 0, (1.0 - missing) * counts / total,
                    missing / max(unseen, 1))


def unseen_share(values: np.ndarray) -> float:
    """The Good-Turing share of values not in ``values``: those seen once
    over the count (1 where nothing was seen)."""
    if len(values) == 0:
        return 1.0
    _, counts = np.unique(values, return_counts=True)
    return float((counts == 1).sum()) / len(values)


def quotas(p: np.ndarray, n: int) -> np.ndarray:
    """``n`` split by the shares ``p``, largest remainders first."""
    exact = p * n
    out = np.floor(exact).astype(np.int64)
    out[np.argsort(out - exact, kind="stable")[:n - out.sum()]] += 1
    return out


def generate(sample: np.ndarray, n_entities: int, n_relations: int,
             n_total: int, seed: int) -> np.ndarray:
    """[n_total, 3] int32 distinct (s, r, o) triples drawn from the fit of
    ``sample`` (module docstring), in a shuffled order. Each relation gets
    its share of ``n_total`` exactly; one whose own heads and tails cannot
    give that many distinct triples draws, after 4 rounds, at least half
    of its entities from the whole graph."""
    rng = np.random.default_rng(seed)
    s, r, o = sample[:, 0], sample[:, 1], sample[:, 2]
    entity_p = smoothed(np.bincount(np.concatenate([s, o]),
                                    minlength=n_entities))
    relation_p = smoothed(np.bincount(r, minlength=n_relations))

    def side(seen: np.ndarray, new_share: float, n: int) -> np.ndarray:
        new = rng.random(n) < new_share
        out = np.empty(n, dtype=np.int64)
        if len(seen):
            out[~new] = seen[rng.integers(0, len(seen), int((~new).sum()))]
        out[new] = rng.choice(n_entities, size=int(new.sum()), p=entity_p)
        return out

    parts = []
    for rel, quota in enumerate(quotas(relation_p, n_total)):
        heads, tails = s[r == rel], o[r == rel]
        shares = [unseen_share(heads), unseen_share(tails)]
        pairs = np.empty((0, 2), dtype=np.int64)
        rounds = 0
        while len(pairs) < quota:
            if rounds >= 4:
                shares = [max(x, 0.5) for x in shares]
            n = quota - len(pairs) + 16
            both = np.concatenate([pairs, np.stack(
                [side(heads, shares[0], n), side(tails, shares[1], n)],
                axis=1)])
            _, first = np.unique(both[:, 0] * n_entities + both[:, 1],
                                 return_index=True)
            pairs = both[np.sort(first)]
            rounds += 1
        pairs = pairs[:quota]
        parts.append(np.stack([pairs[:, 0], np.full(quota, rel),
                               pairs[:, 1]], axis=1))
    triples = np.concatenate(parts)
    return triples[rng.permutation(n_total)].astype(np.int32)


def draw(traffic: dict, seed: int) -> dict:
    """{"train", "valid", "test"} triples and the counts of the traffic
    mix's ``sample`` and published ``n_entities``, ``n_relations`` and
    ``n_train``: ``structure_seed``'s graph relabelled by ``seed``."""
    ne, nr = traffic["n_entities"], traffic["n_relations"]
    held_out = load_sample(traffic["sample"])
    train = generate(np.concatenate([held_out["valid"], held_out["test"]]),
                     ne, nr, traffic["n_train"], traffic["structure_seed"])
    rng = np.random.default_rng(seed)
    ent = rng.permutation(ne).astype(np.int32)
    rel = rng.permutation(nr).astype(np.int32)

    def relabel(t):
        return np.stack([ent[t[:, 0]], rel[t[:, 1]], ent[t[:, 2]]], axis=1)
    return {"n_entities": ne, "n_relations": nr, "train": relabel(train),
            "valid": relabel(held_out["valid"]),
            "test": relabel(held_out["test"])}
