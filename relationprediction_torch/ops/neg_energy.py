"""Factored negative energies for the binomial and split losses
(``relationprediction_tpu/ops/neg_energy.py:48-65``, ``:101-111``,
``:215-239``).

Each corrupted entity scores against one factor of its positive:

    energy[n, k] = < codes[neg_values[n, k]], q_sel[n, k] >
    q_sel[n, k]  = q_obj[n]  if the object slot was corrupted, else q_subj[n]

This is the JAX package's ``_direct`` form for float32 streams: gather the
[n, k, d] rows, reduce against both factors, select by the coin. Autograd
gives the backward, a scatter-add of the rows' cotangents into the code
table; in the JAX package ``_take_rows_sorted_bwd`` sorts the ids first to
spare XLA a slow scatter compile, with the same sums. The split loss's
``single_factor_negative_energies`` is the same with one factor a
positive. The bf16 ``_fused`` and ``_single_fused`` paths come with bf16
streams (ROADMAP.md Queue 1 item 1).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import exact_float32


def factored_negative_energies(codes: torch.Tensor, q_subj: torch.Tensor,
                               q_obj: torch.Tensor, neg_values: torch.Tensor,
                               corrupt_object: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg_energy [n, k] f32, ev_sq [n, k] f32).

    codes: [V, d] float32 entity codes; q_subj / q_obj: [n, d] factors;
    neg_values: [n, k] corrupted entity ids; corrupt_object: [n, k] bool
    (True: the object slot is replaced, so the candidate scores against
    ``q_obj`` = object_factor(e1, r)). ev_sq is the sum of squares of each
    gathered row, for the regularization mean.
    """
    exact_float32()
    ev = codes[neg_values.long()]                            # [n, k, d]
    es = torch.einsum("nkd,nd->nk", ev, q_subj)
    eo = torch.einsum("nkd,nd->nk", ev, q_obj)
    energy = es + corrupt_object.to(torch.float32) * (eo - es)
    ev_sq = (ev * ev).sum(-1)
    return energy, ev_sq


def single_factor_negative_energies(codes: torch.Tensor, q: torch.Tensor,
                                    neg_values: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(energy [n, k] f32, ev_sq [n, k] f32) with
    energy[n, k] = < codes[neg_values[n, k]], q[n] >: every corruption of
    a group scores against one factor of its positive (the JAX package's
    ``_single_direct``). ev_sq is the sum of squares of each gathered row.
    """
    exact_float32()
    ev = codes[neg_values.long()]                            # [n, k, d]
    return torch.einsum("nkd,nd->nk", ev, q), (ev * ev).sum(-1)
