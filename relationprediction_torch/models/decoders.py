"""Decoders (``relationprediction_tpu/models/decoders.py``): DistMult only.

Scores exposed to evaluation are sigmoid(energies), as in the reference;
ranking is monotonic in the logits, so ranks are taken on the energies.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops import sddmm


class BilinearDiag:
    """DistMult decoder (``decoders/bilinear_diag.py``)."""

    name = "bilinear-diag"

    def __init__(self, dimension: int, regularization_parameter: float):
        self.dimension = dimension
        self.regularization_parameter = regularization_parameter

    def init(self, generator: torch.Generator) -> Dict:
        return {}

    def energies(self, params, e1, r, e2):
        return sddmm.distmult_energies(e1, r, e2)

    def all_subject_energies(self, params, all_codes, r, e2):
        return sddmm.distmult_all_subjects(all_codes, r, e2)

    def all_object_energies(self, params, all_codes, e1, r):
        return sddmm.distmult_all_objects(all_codes, e1, r)


def build_decoder(name: str, code_dimension: int,
                  regularization_parameter: float) -> BilinearDiag:
    if name == "bilinear-diag":
        return BilinearDiag(code_dimension, regularization_parameter)
    if name in ("complex", "nonlinear-transform"):
        raise NotImplementedError(f"decoder {name!r} is not ported yet "
                                  f"(ROADMAP.md Queue 1 item 6)")
    raise ValueError(f"unknown decoder {name!r}")
