"""Synthetic knowledge graphs drawn from a seed.

The public distribution of FB15k-237 omits its train split, so serving at
realistic scale uses graphs drawn here: ``generate`` / ``like`` with a real
dataset's entity, relation and edge counts and Zipfian vertex popularity
(no signal, for throughput), ``learnable`` from a ground-truth DistMult
(a signal a model can learn, for quality gates) and ``teacher_factors``,
that DistMult's factors. The draws are those of
``relationprediction_tpu/data/synthetic.py``: one seed gives both packages
the same arrays, bit for bit.
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


def _draw_teacher_factors(rng, n_entities, n_relations, latent_dim):
    """The generator's first draws, shared by ``learnable`` and
    ``teacher_factors`` so the teacher's ceiling is scored on the factors
    that drew the data."""
    ent = rng.standard_normal((n_entities, latent_dim))
    rel = rng.standard_normal((n_relations, latent_dim))
    return ent, rel


def teacher_factors(n_entities: int, n_relations: int, *,
                    latent_dim: int = 8, seed: int = 0):
    """(entity [V, k], relation [R, k]) float64 factors behind
    ``learnable(...)`` with the same arguments: scored through the Scorer,
    the teacher's own ranks, the ceiling a trained model is read against."""
    return _draw_teacher_factors(np.random.default_rng(seed), n_entities,
                                 n_relations, latent_dim)


def learnable(n_entities: int, n_relations: int, n_train: int,
              n_valid: int = 0, n_test: int = 0, *, latent_dim: int = 8,
              temperature: float = 2.0, seed: int = 0,
              name: str = "synth-learnable") -> KGDataset:
    """A KG drawn from a ground-truth DistMult
    (``relationprediction_tpu/data/synthetic.py:94-131``).

    Subjects and relations are uniform; each object is drawn from
    softmax(<e_s, w_r, e_v> / T) over every entity v, in chunks of 4,096
    rows with float64 logits and an inverse-CDF draw, so a model of the
    same family can learn it and trained filtered MRR far above 1/V says
    the model learnt.
    """
    rng = np.random.default_rng(seed)
    ent, rel = _draw_teacher_factors(rng, n_entities, n_relations,
                                     latent_dim)

    n_total = n_train + n_valid + n_test
    s = rng.integers(0, n_entities, n_total)
    r = rng.integers(0, n_relations, n_total)

    o = np.empty(n_total, dtype=np.int64)
    chunk = 4096
    for i in range(0, n_total, chunk):
        sc, rc = s[i:i + chunk], r[i:i + chunk]
        logits = (ent[sc] * rel[rc]) @ ent.T / temperature   # [c, V]
        logits -= logits.max(axis=1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(axis=1, keepdims=True)
        cum = np.cumsum(p, axis=1)
        u = rng.random((len(sc), 1))
        o[i:i + chunk] = (cum < u).sum(axis=1)

    triples = np.stack([s, r, o], axis=1).astype(np.int32)
    return KGDataset(
        name=name,
        entities={i: f"e{i}" for i in range(n_entities)},
        relations={i: f"r{i}" for i in range(n_relations)},
        train=triples[:n_train],
        valid=triples[n_train:n_train + n_valid],
        test=triples[n_train + n_valid:],
    )
