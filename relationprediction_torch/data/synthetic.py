"""Synthetic knowledge graphs with the vital statistics of real datasets.

The public distribution of FB15k-237 omits its train split, so serving at
realistic scale uses graphs drawn here from a seed: the same entity,
relation and edge counts, with Zipfian vertex popularity. The draws are
those of ``relationprediction_tpu/data/synthetic.py``: one seed gives both
packages the same arrays.
"""
from __future__ import annotations

import numpy as np

from .dataset import KGDataset

# (n_entities, n_relations, n_train, n_valid, n_test) of the real datasets.
PROFILES = {
    "FB15k-237": (14541, 237, 272115, 17535, 20466),
    "FB15k": (14951, 1345, 483142, 50000, 59071),
    "WN18": (40943, 18, 141442, 5000, 5000),
    "Toy-like": (16, 9, 43, 5, 5),
}


def generate(n_entities: int, n_relations: int, n_train: int,
             n_valid: int = 0, n_test: int = 0, seed: int = 0,
             power: float = 0.8, name: str = "synthetic") -> KGDataset:
    """Sample a random multi-relational graph with Zipfian vertex and
    relation popularity (real KGs are heavy-tailed)."""
    rng = np.random.default_rng(seed)
    n_total = n_train + n_valid + n_test

    ent_w = 1.0 / np.arange(1, n_entities + 1) ** power
    ent_w /= ent_w.sum()
    rel_w = 1.0 / np.arange(1, n_relations + 1) ** 1.0
    rel_w /= rel_w.sum()

    ent_perm = rng.permutation(n_entities)
    rel_perm = rng.permutation(n_relations)

    s = ent_perm[rng.choice(n_entities, size=n_total, p=ent_w)]
    o = ent_perm[rng.choice(n_entities, size=n_total, p=ent_w)]
    r = rel_perm[rng.choice(n_relations, size=n_total, p=rel_w)]

    triples = np.stack([s, r, o], axis=1).astype(np.int32)
    return KGDataset(
        name=name,
        entities={i: f"e{i}" for i in range(n_entities)},
        relations={i: f"r{i}" for i in range(n_relations)},
        train=triples[:n_train],
        valid=triples[n_train:n_train + n_valid],
        test=triples[n_train + n_valid:],
    )


def like(profile: str, seed: int = 0) -> KGDataset:
    """A synthetic dataset with the vital statistics of a named real
    dataset (see PROFILES)."""
    ne, nr, ntr, nva, nte = PROFILES[profile]
    return generate(ne, nr, ntr, nva, nte, seed=seed,
                    name=f"synth-{profile}")
