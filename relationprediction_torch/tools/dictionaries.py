"""Build entity/relation dictionaries from triplet files.

Counterpart of ``code/tools/dictionaries.py``:

    python -m relationprediction_torch.tools.dictionaries \
        --files a.txt#b.txt --entity_dict entities.dict \
        --relation_dict relations.dict

The port's copy of ``relationprediction_tpu/tools/dictionaries.py``.
"""
from __future__ import annotations

import argparse

from ..data import io


def generate_sets(triplet_file: str):
    entity_set, relation_set = set(), set()
    for s, r, o in io.read_triplets(triplet_file):
        entity_set.add(s)
        relation_set.add(r)
        entity_set.add(o)
    return entity_set, relation_set


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Generate a dictionary file from a list of triplet "
                    "files.")
    parser.add_argument("--files", required=True,
                        help="Triplet filepaths (separated by #)")
    parser.add_argument("--relation_dict", required=True)
    parser.add_argument("--entity_dict", required=True)
    args = parser.parse_args(argv)

    entities, relations = set(), set()
    for f in args.files.split("#"):
        e, r = generate_sets(f)
        entities |= e
        relations |= r

    # Sorted for determinism (the reference iterates a set — arbitrary
    # order; determinism is strictly better for reproducibility).
    io.write_dictionary(args.entity_dict,
                        dict(enumerate(sorted(entities))))
    io.write_dictionary(args.relation_dict,
                        dict(enumerate(sorted(relations))))


if __name__ == "__main__":
    main()
