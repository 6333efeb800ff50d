"""DistMult and ComplEx scoring contractions
(``relationprediction_tpu/ops/sddmm.py``).

The all-entity variants are plain [N, d] x [d, V] GEMMs; JAX leaves them to
XLA outside any Pallas kernel, and the port leaves them to ``torch.matmul``
in full float32. ComplEx codes are [re | im], d/2 each.
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


def complex_parts(x: torch.Tensor):
    """(real, imaginary) halves of [re | im] codes."""
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


def complex_energies(e1: torch.Tensor, r: torch.Tensor,
                     e2: torch.Tensor) -> torch.Tensor:
    """ComplEx energies Re<e1, r, conj(e2)> by the 4-term real expansion
    (``complex.py:38-41``)."""
    e1r, e1i = complex_parts(e1)
    e2r, e2i = complex_parts(e2)
    rr, ri = complex_parts(r)
    f32 = torch.float32
    return (torch.sum(e1r * rr * e2r, -1, dtype=f32)
            + torch.sum(e1i * rr * e2i, -1, dtype=f32)
            + torch.sum(e1r * ri * e2i, -1, dtype=f32)
            - torch.sum(e1i * ri * e2r, -1, dtype=f32))


def complex_all_subjects(all_codes: torch.Tensor, r: torch.Tensor,
                         e2: torch.Tensor) -> torch.Tensor:
    """[N, V] ComplEx energies against every candidate subject, 4 GEMMs
    (``complex.py:77-93``)."""
    exact_float32()
    ar, ai = complex_parts(all_codes)
    e2r, e2i = complex_parts(e2)
    rr, ri = complex_parts(r)
    return (torch.matmul(rr * e2r, ar.T) + torch.matmul(rr * e2i, ai.T)
            + torch.matmul(ri * e2i, ar.T) - torch.matmul(ri * e2r, ai.T))


def complex_all_objects(all_codes: torch.Tensor, e1: torch.Tensor,
                        r: torch.Tensor) -> torch.Tensor:
    """[N, V] ComplEx energies against every candidate object, 4 GEMMs
    (``complex.py:95-106``)."""
    exact_float32()
    ar, ai = complex_parts(all_codes)
    e1r, e1i = complex_parts(e1)
    rr, ri = complex_parts(r)
    return (torch.matmul(e1r * rr, ar.T) + torch.matmul(e1i * rr, ai.T)
            + torch.matmul(e1r * ri, ai.T) - torch.matmul(e1i * ri, ar.T))
