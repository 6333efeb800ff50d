"""Factored negative energies for the binomial and split losses
(``relationprediction_tpu/ops/neg_energy.py``).

Each corrupted entity scores against one factor of its positive:

    energy[n, k] = < codes[neg_values[n, k]], q_sel[n, k] >
    q_sel[n, k]  = q_obj[n]  if the object slot was corrupted, else q_subj[n]

The JAX package's dispatch rule (``neg_energy.py:60-65``, ``:224-229``;
``fused_backward_applies``) picks one of two forms:

* ``_direct`` (float32 streams, small shapes, few entities): gather the
  [n, k, d] rows, reduce against both factors, select by the coin.
  The gather is ``gather.take_rows``, whose backward sums the rows'
  cotangents into the code table by id in a fixed order; in the JAX
  package ``_take_rows_sorted_bwd`` sorts the ids first to spare XLA a
  slow scatter compile, with the same sums.
* ``_fused`` (bf16 codes, n·k >= 8192 and V >= 1024): the same forward,
  products in bf16 and sums in f32, and a backward built on the rank
  structure of the code table's cotangent (``neg_energy.py:114-207``):

      d codes[v] = sum_{j: neg_j = v} dE_j * qcat[fsel_j]
                   + codes[v] * sum_{j: neg_j = v} 2 dS_j

  with qcat = [q_subj; q_obj] and fsel_j the factor row of entry j. The
  ids are sorted on the device into a CSR by id (``gather.id_csr``: its
  row_ptr a ``torch.searchsorted`` over 0..V, no host sync), and the
  first term is TPU kernel 3's bf16 entry point (``staircase.aggregate``:
  messages the bf16 qcat, perm the sorted fsel, weights dE in f32); the
  second is a per-id scalar sum of the 2 dS in f32 on the same CSR
  (``gather.add_by_id``, kernel 3's f32 entry point) times codes. Where
  the JAX package accumulates
  a bf16 payload through its windowed one-hot loop
  (``scatter_accum.accumulate_sorted_payload``), kernel 3 sums in f32:
  no [n, k, d] payload, deterministic, and no sort-based ``index_put_``.
  The code-table gradient is rounded to the codes' bf16, as in the JAX
  package. On a CPU tensor kernel 3's plain version runs: an f32
  ``index_add_`` of the same terms. No sum adds with atomics, so two
  backwards on one input give the same bits.

The split loss's ``single_factor_negative_energies`` is the same with one
factor a positive (``_single_fused``: fsel = j // k).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import exact_float32
from ..graph import CsrLayout
from . import staircase
from .gather import add_by_id, id_csr, take_rows

# The JAX package's _CHUNK and _WINDOW: the fused backward takes n·k >=
# 4 * _CHUNK entries over V >= 2 * _WINDOW entities.
_CHUNK = 2048
_WINDOW = 512


def fused_backward_applies(codes: torch.Tensor, n: int, k: int) -> bool:
    """The JAX package's dispatch rule (``neg_energy.py:62-65``): bf16
    codes, n * k >= 4 * 2048 corrupted rows and V >= 2 * 512 entities take
    the fused backward, anything else the direct form."""
    return (codes.dtype == torch.bfloat16 and n * k >= 4 * _CHUNK
            and codes.shape[0] >= 2 * _WINDOW)


def factored_negative_energies(codes: torch.Tensor, q_subj: torch.Tensor,
                               q_obj: torch.Tensor, neg_values: torch.Tensor,
                               corrupt_object: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg_energy [n, k] f32, ev_sq [n, k] f32).

    codes: [V, d] entity codes (float32, or bf16 on a bf16 stream);
    q_subj / q_obj: [n, d] factors in the codes' dtype; neg_values: [n, k]
    corrupted entity ids; corrupt_object: [n, k] bool (True: the object
    slot is replaced, so the candidate scores against ``q_obj`` =
    object_factor(e1, r)). ev_sq is the sum of squares of each gathered
    row, for the regularization mean.
    """
    n, k = neg_values.shape
    if fused_backward_applies(codes, n, k):
        return _Fused.apply(codes, q_subj, q_obj, neg_values,
                            corrupt_object)
    if codes.dtype == torch.bfloat16:
        return _bf16_forward(codes, neg_values, q_subj, q_obj,
                             coin=corrupt_object)[:2]
    exact_float32()
    ev = take_rows(codes, neg_values)                        # [n, k, d]
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
    ``_single_direct``, or ``_single_fused`` by the same rule as
    ``factored_negative_energies``). ev_sq is the sum of squares of each
    gathered row.
    """
    n, k = neg_values.shape
    if fused_backward_applies(codes, n, k):
        return _SingleFused.apply(codes, q, neg_values)
    if codes.dtype == torch.bfloat16:
        return _bf16_forward(codes, neg_values, q)[:2]
    exact_float32()
    ev = take_rows(codes, neg_values)                        # [n, k, d]
    return torch.einsum("nkd,nd->nk", ev, q), (ev * ev).sum(-1)


# Launches of kernel 3's bf16 entry point by the fused backwards since the
# counts were last set to 0 (CPU calls never count; each launch also adds
# its carry fix-up to staircase.staircase_aggregate.fixup_launches).
factored_negative_energies.bf16_launches = 0
single_factor_negative_energies.bf16_launches = 0


def _reduce(ev: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """sum_d ev[n, k, d] * q[n, d]: the products in the stream dtype,
    summed in f32 (the JAX package's broadcast-multiply-reduce with
    ``dtype=float32``)."""
    return (ev * q[:, None, :]).sum(-1, dtype=torch.float32)


def _row_squares(codes: torch.Tensor, neg_values: torch.Tensor
                 ) -> torch.Tensor:
    """ev_sq [n, k]: each gathered row's f32 sum of squares, computed once
    per entity and gathered (no [n, k, d] f32 copy)."""
    return take_rows((codes.float() ** 2).sum(-1), neg_values)


def _bf16_forward(codes: torch.Tensor, neg_values: torch.Tensor,
                  *factors: torch.Tensor, coin=None) -> tuple:
    """(energy [n, k] f32, ev_sq [n, k] f32, ev [n, k, d]) on a bf16
    stream, for both forms: the gathered rows reduced against each factor
    in f32 (``_reduce``), the two selected by ``coin`` (True: the second)
    where two are given, ev_sq by ``_row_squares``."""
    ev = take_rows(codes, neg_values)                        # [n, k, d]
    energy = _reduce(ev, factors[0])
    if coin is not None:
        energy = energy + coin.to(torch.float32) * (
            _reduce(ev, factors[1]) - energy)
    return energy, _row_squares(codes, neg_values), ev


def _code_grads(codes: torch.Tensor, qcat: torch.Tensor,
                rows: torch.Tensor, w_e: torch.Tensor, w_s: torch.Tensor,
                fsel: torch.Tensor, counter) -> torch.Tensor:
    """d codes [V, d] in the codes' dtype: sum_{j: rows_j = v} w_e[j] *
    qcat[fsel[j]] + codes[v] * sum_{j: rows_j = v} w_s[j]. The entries are
    sorted by id into a CSR (``id_csr``); kernel 3 sums the first term (a
    launch counted on ``counter``), ``add_by_id`` the per-id scalars in
    f32 on the same CSR."""
    v = codes.shape[0]
    row_ptr, order = id_csr(rows, v)
    perm = fsel[order].to(torch.int32)
    layout = CsrLayout(row_ptr=row_ptr, src=perm, rel=perm,
                       w=w_e[order].to(torch.float32).contiguous())
    first = staircase.aggregate(qcat.contiguous(), layout, v, perm,
                                counter=counter)
    scale = add_by_id(torch.zeros(v, 1, dtype=torch.float32,
                                  device=codes.device),
                      rows, w_s.to(torch.float32)[:, None],
                      csr=(row_ptr, order))
    return (first + codes.float() * scale).to(codes.dtype)


class _Fused(torch.autograd.Function):
    """The JAX package's ``_fused`` (``neg_energy.py:114-207``): forward
    from the gathered bf16 rows, energies reduced in f32 and ev_sq from
    f32 squares; backward dq_subj / dq_obj as f32-accumulated reductions
    over the rows, and d codes by ``_code_grads``."""

    @staticmethod
    def forward(ctx, codes, q_subj, q_obj, neg_values, corrupt_object):
        energy, ev_sq, ev = _bf16_forward(codes, neg_values, q_subj, q_obj,
                                          coin=corrupt_object)
        ctx.save_for_backward(codes, q_subj, q_obj, neg_values,
                              corrupt_object, ev)
        return energy, ev_sq

    @staticmethod
    def backward(ctx, d_energy, d_sq):
        codes, q_subj, q_obj, neg_values, corrupt_object, ev = \
            ctx.saved_tensors
        n, k = neg_values.shape
        co = corrupt_object.to(torch.float32)
        d_energy, d_sq = d_energy.float(), d_sq.float()
        a = (d_energy * (1.0 - co)).to(ev.dtype)
        b = (d_energy * co).to(ev.dtype)
        dq_subj = (a[:, :, None] * ev).sum(1, dtype=torch.float32) \
            .to(q_subj.dtype)
        dq_obj = (b[:, :, None] * ev).sum(1, dtype=torch.float32) \
            .to(q_obj.dtype)
        fsel = (torch.arange(n * k, device=codes.device) // k
                + corrupt_object.reshape(-1).long() * n)
        d_codes = _code_grads(
            codes, torch.cat([q_subj, q_obj]), neg_values.reshape(-1),
            d_energy.reshape(-1), 2.0 * d_sq.reshape(-1), fsel,
            factored_negative_energies)
        return d_codes, dq_subj, dq_obj, None, None


class _SingleFused(torch.autograd.Function):
    """The JAX package's ``_single_fused`` (``neg_energy.py:224-279``):
    ``_Fused`` with one factor a positive."""

    @staticmethod
    def forward(ctx, codes, q, neg_values):
        energy, ev_sq, ev = _bf16_forward(codes, neg_values, q)
        ctx.save_for_backward(codes, q, neg_values, ev)
        return energy, ev_sq

    @staticmethod
    def backward(ctx, d_energy, d_sq):
        codes, q, neg_values, ev = ctx.saved_tensors
        n, k = neg_values.shape
        d_energy, d_sq = d_energy.float(), d_sq.float()
        dq = (d_energy.to(ev.dtype)[:, :, None] * ev) \
            .sum(1, dtype=torch.float32).to(q.dtype)
        d_codes = _code_grads(
            codes, q, neg_values.reshape(-1), d_energy.reshape(-1),
            2.0 * d_sq.reshape(-1),
            torch.arange(n * k, device=codes.device) // k,
            single_factor_negative_energies)
        return d_codes, dq, None
