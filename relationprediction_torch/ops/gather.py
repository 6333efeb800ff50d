"""Row gathers of a table by ids, and sums by id, whose results do not
depend on the order in which threads or atomics happen to add.

A fit at a fixed seed gives the same params bit for bit, run after run,
at PyTorch's default settings (no ``torch.use_deterministic_algorithms``,
which is process-wide state that a library does not set for its caller).
Two kinds of sum stood in the way, and this module holds the port's one
answer to each:

* ``take_rows(table, ids)`` is ``table[ids]``. Autograd's backward of that
  gather is ``index_put_(accumulate=True)``, which on a float32 or float64
  CPU tensor adds in parallel over the ids, with atomics, once the
  cotangent holds more than one grain of work (32,768 elements), in an
  order that changes from call to call (PyTorch lists it as
  nondeterministic). ``take_rows`` sums each id's rows in the cotangent's
  own dtype, one row after the other in index order, as the JAX package's
  scatter-add does on the CPU (same bits): a float32 or float64 CPU
  cotangent with ``index_add_`` (serial over the index); any other keeps
  autograd's ``index_put_(accumulate=True)``, which adds a bf16 CPU
  cotangent serially in bf16 (``index_add_`` would add it in f32, away from
  JAX's sums) and a CUDA one with a sort-based kernel that PyTorch does
  not list as nondeterministic.
* ``add_by_id(out, ids, values)`` adds values[j] into out[ids[j]]. On a
  CPU tensor it is ``index_add_``. On a CUDA tensor ``index_add_`` adds
  with atomics, so instead the ids are sorted (stable, on the device) into
  a CSR by id whose row_ptr comes from ``torch.searchsorted`` (``id_csr``;
  no host sync) and TPU kernel 3 (``sum_by_csr``: ``staircase.aggregate``,
  perm the sort order, no weights) sums each id's rows in f32, in a fixed
  order, with no atomics. d blocks, d C and the fused energies' backward
  (``ops/staircase2.py``, ``ops/neg_energy.py``) sum by relation or by
  entity through it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..graph import CsrLayout
from . import staircase


def take_rows(table: torch.Tensor, ids: torch.Tensor,
              csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """``table[ids]``: [*ids.shape, *table.shape[1:]], differentiable in
    ``table`` with a gradient summed by id in a fixed order (module
    docstring). ``ids`` is any integer tensor on the table's device.
    ``csr``: the CSR by id of a 1-d ``ids`` (``id_csr``'s output, made
    once for ids that do not change): a float32 gradient is then summed by
    ``add_by_id`` over it, for ids whose rows repeat many times (a long
    run of one id is a serial loop in ``index_put_``'s CUDA kernel)."""
    return _TakeRows.apply(table, ids, csr)


# The dtypes whose CPU index_put_(accumulate=True) adds with atomics in
# parallel; index_add_ adds them serially in their own dtype.
_PARALLEL_INDEX_PUT = (torch.float32, torch.float64)


class _TakeRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids, csr=None):
        ids = ids.long()
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        ctx.csr = csr
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        ids, = ctx.saved_tensors
        flat_ids = ids.reshape(-1)
        rows = g.reshape(flat_ids.shape[0], *ctx.table_shape[1:])
        d_table = g.new_zeros(ctx.table_shape)
        if ctx.csr is not None and g.dtype == torch.float32:
            add_by_id(d_table, flat_ids, rows, ctx.csr)
        elif g.device.type == "cpu" and g.dtype in _PARALLEL_INDEX_PUT:
            d_table.index_add_(0, flat_ids, rows)
        else:
            d_table.index_put_((flat_ids,), rows, accumulate=True)
        return d_table, None, None


def id_csr(ids: torch.Tensor, n_ids: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(row_ptr int32 [n_ids + 1], order int64 [N]): the CSR by id of the
    N entries of ``ids`` (values in [0, n_ids)), entry k of the CSR being
    entry ``order[k]`` of ``ids``. The sort is stable, so each id's entries
    keep their order; row_ptr is a ``torch.searchsorted`` of 0..n_ids into
    the sorted ids, on their device, with no host sync."""
    ids = ids.reshape(-1).long()
    order = torch.argsort(ids, stable=True)
    row_ptr = torch.searchsorted(
        ids[order], torch.arange(n_ids + 1, device=ids.device))
    return row_ptr.to(torch.int32), order


def add_by_id(out: torch.Tensor, ids: torch.Tensor, values: torch.Tensor,
              csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """out[i] += sum over j with ids[j] = i of values[j]; returns ``out``.

    out: [n_ids, ...] float32; ids: [N] integer; values: [N, ...] float32
    of out's row shape. On a CPU tensor one ``index_add_``. On a CUDA tensor
    ``sum_by_csr`` over the CSR by id (``csr``, else ``id_csr(ids,
    n_ids)``), then added into ``out``: the same bits at every call."""
    if out.device.type == "cpu":
        return out.index_add_(0, ids.reshape(-1).long(), values)
    n_ids = out.shape[0]
    row_ptr, order = id_csr(ids, n_ids) if csr is None else csr
    sums = sum_by_csr(values.reshape(values.shape[0], -1), row_ptr, order,
                      n_ids)
    return out.add_(sums.view_as(out))


def sum_by_csr(values: torch.Tensor, row_ptr: torch.Tensor,
               order: torch.Tensor, n_ids: int) -> torch.Tensor:
    """[n_ids, w] float32: row i the sum of values[order[k]] over the CSR
    entries k of row i (``id_csr``'s output), in entry order. One call of
    kernel 3's f32 entry point (``staircase.aggregate``, perm the order, no
    weights), counted on ``sum_by_csr.launches``, or its plain version for
    a CPU tensor. values: [N, w] float32."""
    perm = order.to(torch.int32)
    # Kernel 3 reads no weight here (weighted=False); w is only the
    # layout's [N] float32 slot, left unset.
    layout = CsrLayout(row_ptr=row_ptr, src=perm, rel=perm,
                       w=torch.empty(perm.shape[0], dtype=torch.float32,
                                     device=values.device))
    return staircase.aggregate(values.contiguous(), layout, n_ids, perm,
                               weighted=False, counter=sum_by_csr)


# Kernel 3 launches by sum_by_csr since the counts were last set to 0 (CPU
# calls never count; each also adds its carry fix-up to
# staircase.staircase_aggregate.fixup_launches). Its values are f32, so
# bf16_launches stays 0.
sum_by_csr.launches = 0
sum_by_csr.bf16_launches = 0
