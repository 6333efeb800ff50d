"""DistMult scoring contractions (``relationprediction_tpu/ops/sddmm.py``).

The all-entity variants are plain [N, d] x [d, V] GEMMs; JAX leaves them to
XLA outside any Pallas kernel, and the port leaves them to ``torch.matmul``
in full float32.
"""
from __future__ import annotations

import torch

from ..device import exact_float32


def distmult_energies(e1: torch.Tensor, r: torch.Tensor,
                      e2: torch.Tensor) -> torch.Tensor:
    """DistMult triple energies: sum_d e1 * r * e2 (``bilinear_diag.py:30``)."""
    return torch.sum(e1 * r * e2, dim=-1, dtype=torch.float32)


def distmult_all_subjects(all_codes: torch.Tensor, r: torch.Tensor,
                          e2: torch.Tensor) -> torch.Tensor:
    """[N, V] energies against every candidate subject
    (``bilinear_diag.py:55-57``): (r * e2) @ all_codes^T."""
    exact_float32()
    return torch.matmul(r * e2, all_codes.T)


def distmult_all_objects(all_codes: torch.Tensor, e1: torch.Tensor,
                         r: torch.Tensor) -> torch.Tensor:
    """[N, V] energies against every candidate object
    (``bilinear_diag.py:59-61``): (e1 * r) @ all_codes^T."""
    exact_float32()
    return torch.matmul(e1 * r, all_codes.T)
