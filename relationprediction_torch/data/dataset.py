"""Knowledge-graph dataset container.

Bundles what the reference driver assembles ad hoc at
``code/train.py:22-48`` (entity/relation dicts + train/valid/test id-triple
arrays) into one object, with loaders for on-disk datasets and synthetic
generators for benchmarking when the original splits are unavailable.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from . import io


@dataclass
class KGDataset:
    name: str
    entities: Dict[int, str]
    relations: Dict[int, str]
    train: np.ndarray  # [N, 3] int32 (s, r, o)
    valid: np.ndarray
    test: np.ndarray
    # Optional pairwise accuracy-metric splits (valid_accuracy.txt et al.,
    # train.py:33-35):
    valid_accuracy: Optional[np.ndarray] = None
    test_accuracy: Optional[np.ndarray] = None

    @property
    def n_entities(self) -> int:
        return len(self.entities)

    @property
    def n_relations(self) -> int:
        return len(self.relations)

    def all_triples(self) -> np.ndarray:
        return np.concatenate([self.train, self.valid, self.test], axis=0)


def load(path: str, metric: str = "MRR") -> KGDataset:
    """Load a dataset directory in the reference layout
    (entities.dict / relations.dict / train.txt / valid.txt / test.txt)."""
    entities_path = os.path.join(path, "entities.dict")
    relations_path = os.path.join(path, "relations.dict")

    def triples(split: str) -> np.ndarray:
        p = os.path.join(path, split)
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} is missing. The public distribution of this dataset "
                f"omits some splits; regenerate or use data.synthetic.")
        return io.read_triplets_as_array(p, entities_path, relations_path)

    if metric == "Accuracy":
        valid = triples("valid_accuracy.txt")
        test = triples("test_accuracy.txt")
    else:
        valid = triples("valid.txt")
        test = triples("test.txt")

    return KGDataset(
        name=os.path.basename(os.path.normpath(path)),
        entities=io.read_dictionary(entities_path),
        relations=io.read_dictionary(relations_path),
        train=triples("train.txt"),
        valid=valid,
        test=test,
    )


def from_arrays(train: np.ndarray, valid: np.ndarray, test: np.ndarray,
                n_entities: Optional[int] = None,
                n_relations: Optional[int] = None,
                name: str = "arrays") -> KGDataset:
    """A dataset from id-triple arrays (``data/dataset.py:75-91`` of the
    JAX package); the counts default to one past the largest id seen."""
    allt = np.concatenate([train, valid, test], axis=0)
    if n_entities is None:
        n_entities = int(max(allt[:, 0].max(), allt[:, 2].max())) + 1
    if n_relations is None:
        n_relations = int(allt[:, 1].max()) + 1
    return KGDataset(
        name=name,
        entities={i: f"e{i}" for i in range(n_entities)},
        relations={i: f"r{i}" for i in range(n_relations)},
        train=train.astype(np.int32),
        valid=valid.astype(np.int32),
        test=test.astype(np.int32),
    )
