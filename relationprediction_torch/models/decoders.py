"""Decoders (``relationprediction_tpu/models/decoders.py``): DistMult and
ComplEx, and the losses they share.

Scores exposed to evaluation are sigmoid(energies), as in the reference;
ranking is monotonic in the logits, so ranks are taken on the energies.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import sddmm


def masked_mean(x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the entries where ``mask`` is 1 (``decoders.py:23-36``),
    with the count clamped to at least 1."""
    if mask is None:
        return x.sum() / max(x.numel(), 1)
    return (x * mask.to(x.dtype)).sum() / mask.sum().clamp(min=1.0)


def weighted_ce_loss(energies: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean sigmoid cross-entropy with logits (``decoders.py:39-48``), in
    the stable form max(x, 0) - x*y + log1p(exp(-|x|)). The reference
    reads NegativeSampleRate as a positive-class weight and then overrides
    it to 1 (``bilinear_diag.py:32-33``), so the CE is unweighted."""
    ce = (torch.clamp(energies, min=0.0) - energies * labels
          + torch.log1p(torch.exp(-energies.abs())))
    return masked_mean(ce, mask)


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

    # DistMult is linear in each entity code given the other two, so a
    # corrupted subject or object scores against one factor per positive
    # (``decoders.py:76-87``): energy(e1) = e1 . (r * e2),
    # energy(e2) = (e1 * r) . e2.
    factorizable = True

    def subject_factor(self, params, r, e2):
        """q with energy(candidate subject e) = e . q."""
        return r * e2

    def object_factor(self, params, e1, r):
        return e1 * r

    def regularization(self, params, e1, r, e2, mask=None):
        """reg_param * (mean e1^2 + mean r^2 + mean e2^2) over the batch
        codes (``bilinear_diag.py:63-69``)."""
        m = None if mask is None else mask[:, None] * torch.ones_like(e1)
        reg = (masked_mean(e1 ** 2, m) + masked_mean(r ** 2, m)
               + masked_mean(e2 ** 2, m))
        return self.regularization_parameter * reg


class Complex(BilinearDiag):
    """ComplEx decoder (``decoders/complex.py``); codes are [re | im]."""

    name = "complex"

    def energies(self, params, e1, r, e2):
        return sddmm.complex_energies(e1, r, e2)

    # ComplEx is bilinear too (``decoders.py:111-126``): energy(e1) = e1 . q
    # with q = [rr*e2r + ri*e2i | rr*e2i - ri*e2r], and energy(e2) = q' . e2
    # with q' = [e1r*rr - e1i*ri | e1i*rr + e1r*ri].
    def subject_factor(self, params, r, e2):
        rr, ri = sddmm.complex_parts(r)
        e2r, e2i = sddmm.complex_parts(e2)
        return torch.cat([rr * e2r + ri * e2i, rr * e2i - ri * e2r], dim=-1)

    def object_factor(self, params, e1, r):
        rr, ri = sddmm.complex_parts(r)
        e1r, e1i = sddmm.complex_parts(e1)
        return torch.cat([e1r * rr - e1i * ri, e1i * rr + e1r * ri], dim=-1)

    def all_subject_energies(self, params, all_codes, r, e2):
        return sddmm.complex_all_subjects(all_codes, r, e2)

    def all_object_energies(self, params, all_codes, e1, r):
        return sddmm.complex_all_objects(all_codes, e1, r)


def build_decoder(name: str, code_dimension: int,
                  regularization_parameter: float) -> BilinearDiag:
    if name == "bilinear-diag":
        return BilinearDiag(code_dimension, regularization_parameter)
    if name == "complex":
        return Complex(code_dimension, regularization_parameter)
    if name == "nonlinear-transform":
        raise NotImplementedError(f"decoder {name!r} is not ported yet "
                                  f"(ROADMAP.md Queue 1 item 2)")
    raise ValueError(f"unknown decoder {name!r}")
