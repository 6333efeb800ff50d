"""Knowledge-graph triplet and dictionary readers and writers.

Format-compatible with the reference readers (``code/common/io.py``):
``entities.dict``/``relations.dict`` are ``id\tname`` TSV, triple files are
``s_name\tr_name\to_name`` TSV. Same code as
``relationprediction_tpu/data/io.py``.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def read_dictionary(filename: str, id_lookup: bool = True) -> Dict:
    """Read an ``id\tname`` TSV mapping (``io.py:5-16``).

    id_lookup=True returns {id: name}; False returns {name: id}.
    """
    d: Dict = {}
    with open(filename) as f:
        for line in f:
            if not line.strip():
                continue
            parts = line.strip().split("\t")
            if id_lookup:
                d[int(parts[0])] = parts[1]
            else:
                d[parts[1]] = int(parts[0])
    return d


def read_triplets(filename: str) -> List[List[str]]:
    with open(filename) as f:
        return [line.strip().split("\t") for line in f if line.strip()]


def read_triplets_as_array(filename: str, entities_path: str,
                           relations_path: str) -> np.ndarray:
    """Read a name-TSV triple file into an int32 [N, 3] array of
    (subject, relation, object) ids (``io.py:27-39``)."""
    entity_dict = read_dictionary(entities_path, id_lookup=False)
    relation_dict = read_dictionary(relations_path, id_lookup=False)

    rows = []
    for s, r, o in read_triplets(filename):
        rows.append((entity_dict[s], relation_dict[r], entity_dict[o]))
    return np.asarray(rows, dtype=np.int32).reshape(-1, 3)


def write_triplets(filename: str, triples: np.ndarray,
                   entities: Dict[int, str], relations: Dict[int, str]) -> None:
    """Inverse of read_triplets_as_array: write id triples as name TSV."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        for s, r, o in triples:
            f.write(f"{entities[int(s)]}\t{relations[int(r)]}\t"
                    f"{entities[int(o)]}\n")


def write_dictionary(filename: str, d: Dict[int, str]) -> None:
    """Write an ``id\tname`` TSV mapping, ids in ascending order."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        for i in sorted(d):
            f.write(f"{i}\t{d[i]}\n")
