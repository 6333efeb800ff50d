"""Factored negative energies for the binomial and split losses
(``relationprediction_tpu/ops/neg_energy.py``).

Each corrupted entity scores against one factor of its positive:

    energy[n, k] = < codes[neg_values[n, k]], q_sel[n, k] >
    q_sel[n, k]  = q_obj[n]  if the object slot was corrupted, else q_subj[n]

``energy_route`` picks one of three forms from what it can see of the
codes:

* ``direct`` (the JAX package's ``_direct``; every CPU call in float32
  or float64, bf16 below the fused form's thresholds): gather the
  [n, k, d] rows, reduce against both factors, select by the coin.
  The gather is ``gather.take_rows``, whose backward sums the rows'
  cotangents into the code table by id in a fixed order; in the JAX
  package ``_take_rows_sorted_bwd`` sorts the ids first to spare XLA a
  slow scatter compile, with the same sums.
* ``fused`` (the JAX package's ``_fused`` by its rule,
  ``neg_energy.py:60-65``, ``:224-229``; ``fused_backward_applies``: bf16
  codes, n·k >= 8192 and V >= 1024): the same forward, products in bf16
  and sums in f32, and a backward built on the rank structure of the code
  table's cotangent (``neg_energy.py:114-207``):

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
* ``gather_dot`` (float32 codes on a CUDA card, at every size): the fused
  backward carried over to float32, with a hand kernel forward. The
  forward is ``gather_dot_kernel`` (``csrc/neg_energy.cu``): each
  gathered row is read once and scored against the selected factor, its
  sum of squares taken in the same pass, and no [n, k, d] tensor is
  written. The backward takes d q_subj / d q_obj by the same source's
  ``gather_dot_grad_kernel`` and d codes by the formula above
  (``_code_grads``, kernel 3's f32 entry point for both sums), so no
  ``index_put_`` runs. Every sum is f32 in a fixed order (the same bits
  at every call) and nothing waits on the host (a CUDA graph captures
  it). Computing only the selected factor's dot is the energy of the
  tiled triple itself; it differs from the direct form's
  ``es + co * (eo - es)`` only in rounding. On a CPU tensor the kernels'
  plain versions (``gather_dot_reference``, ``gather_dot_grad_reference``)
  run, for the tests.

The split loss's ``single_factor_negative_energies`` is the same with one
factor a positive (``_single_fused``: fsel = j // k; the gather-dot with
no coin).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..device import exact_float32
from ..graph import CsrLayout
from . import nvcc, staircase
from .gather import add_by_id, id_csr, sum_by_csr, take_rows

_SOURCE = "neg_energy.cu"
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


def energy_route(codes, n: int, k: int) -> str:
    """The form an energies call on ``codes`` ([V, d]; anything with a
    ``dtype``, a ``device`` and a ``shape``) takes for n positives of k
    corruptions: "fused" where ``fused_backward_applies``, "gather_dot"
    for float32 codes on a CUDA device, else "direct"."""
    if fused_backward_applies(codes, n, k):
        return "fused"
    if codes.dtype == torch.float32 and codes.device.type == "cuda":
        return "gather_dot"
    return "direct"


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
    route = energy_route(codes, n, k)
    if route == "fused":
        return _Fused.apply(codes, q_subj, q_obj, neg_values,
                            corrupt_object)
    if route == "gather_dot":
        return _GatherDot.apply(codes, q_subj, q_obj, neg_values,
                                corrupt_object.contiguous(),
                                factored_negative_energies)
    if codes.dtype == torch.bfloat16:
        return _bf16_forward(codes, neg_values, q_subj, q_obj,
                             coin=corrupt_object)[:2]
    return direct_energies(codes, neg_values, q_subj, q_obj, corrupt_object)


def single_factor_negative_energies(codes: torch.Tensor, q: torch.Tensor,
                                    neg_values: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(energy [n, k] f32, ev_sq [n, k] f32) with
    energy[n, k] = < codes[neg_values[n, k]], q[n] >: every corruption of
    a group scores against one factor of its positive (the JAX package's
    ``_single_direct``, or ``_single_fused`` by the same rule as
    ``factored_negative_energies``, or the gather-dot with no coin). ev_sq
    is the sum of squares of each gathered row.
    """
    n, k = neg_values.shape
    route = energy_route(codes, n, k)
    if route == "fused":
        return _SingleFused.apply(codes, q, neg_values)
    if route == "gather_dot":
        return _GatherDot.apply(codes, q, None, neg_values, None,
                                single_factor_negative_energies)
    if codes.dtype == torch.bfloat16:
        return _bf16_forward(codes, neg_values, q)[:2]
    return direct_energies(codes, neg_values, q)


def direct_energies(codes: torch.Tensor, neg_values: torch.Tensor,
                    q_subj: torch.Tensor, q_obj: Optional[torch.Tensor] = None,
                    coin: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The direct form in float32 (or float64), through autograd: the
    gathered [n, k, d] rows reduced against q_subj and, where ``q_obj`` is
    given, against q_obj too, the two selected by ``coin``; ev_sq the
    rows' sums of squares. The gather-dot route computes the same
    function; ``chip_smoke.py`` times this form on the card beside it."""
    exact_float32()
    ev = take_rows(codes, neg_values)                        # [n, k, d]
    es = torch.einsum("nkd,nd->nk", ev, q_subj)
    if q_obj is None:
        return es, (ev * ev).sum(-1)
    eo = torch.einsum("nkd,nd->nk", ev, q_obj)
    energy = es + coin.to(torch.float32) * (eo - es)
    ev_sq = (ev * ev).sum(-1)
    return energy, ev_sq


# Launches since the counts were last set to 0 (CPU calls never count):
# bf16_launches, kernel 3's bf16 entry point by the fused backwards (each
# also adds its carry fix-up to staircase.staircase_aggregate.
# fixup_launches); f32_launches, gather_dot_kernel (one a gather-dot
# forward), and f32_grad_launches, gather_dot_grad_kernel (one a
# gather-dot backward, whose two kernel 3 launches count on
# gather.sum_by_csr).
factored_negative_energies.bf16_launches = 0
single_factor_negative_energies.bf16_launches = 0
factored_negative_energies.f32_launches = 0
single_factor_negative_energies.f32_launches = 0
factored_negative_energies.f32_grad_launches = 0
single_factor_negative_energies.f32_grad_launches = 0


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
    launch counted on ``counter``), ``add_by_id`` the per-id scalars on
    the same CSR. Sums in f32 (float64 for float64 codes, which only the
    CPU's plain versions take)."""
    v = codes.shape[0]
    acc = torch.float64 if codes.dtype == torch.float64 else torch.float32
    row_ptr, order = id_csr(rows, v)
    perm = fsel[order].to(torch.int32)
    layout = CsrLayout(row_ptr=row_ptr, src=perm, rel=perm,
                       w=w_e[order].to(acc).contiguous())
    first = staircase.aggregate(qcat.contiguous(), layout, v, perm,
                                counter=counter)
    scale = add_by_id(torch.zeros(v, 1, dtype=acc, device=codes.device),
                      rows, w_s.to(acc)[:, None], csr=(row_ptr, order))
    return (first + codes.to(acc) * scale).to(codes.dtype)


def _factor_rows(n: int, k: int, coin: Optional[torch.Tensor],
                 device) -> torch.Tensor:
    """fsel [n * k]: the row of qcat = [q_subj; q_obj] (or of q alone,
    where ``coin`` is None) that entry j scores against."""
    fsel = torch.arange(n * k, device=device) // k
    return fsel if coin is None else fsel + coin.reshape(-1).long() * n


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
        d_codes = _code_grads(
            codes, torch.cat([q_subj, q_obj]), neg_values.reshape(-1),
            d_energy.reshape(-1), 2.0 * d_sq.reshape(-1),
            _factor_rows(n, k, corrupt_object, codes.device),
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
            _factor_rows(n, k, None, codes.device),
            single_factor_negative_energies)
        return d_codes, dq, None


class _GatherDot(torch.autograd.Function):
    """The gather-dot route: (energy, ev_sq) by ``gather_dot``; backward
    d q_subj / d q_obj by ``gather_dot_grad``, d codes by ``_code_grads``
    (its kernel 3 launches counted on ``gather.sum_by_csr``). ``q_obj``
    and ``coin`` are None for the single-factor form. Saves the codes,
    the factors, the ids and the coins: no gathered rows."""

    @staticmethod
    def forward(ctx, codes, q_subj, q_obj, neg_values, coin, counter):
        # The device draws are [k, n] transposed int32: one contiguous
        # int64 copy serves the kernels and the sort of the backward.
        neg_values = neg_values.to(torch.int64,
                                   memory_format=torch.contiguous_format)
        codes, q_subj = codes.contiguous(), q_subj.contiguous()
        q_obj = None if q_obj is None else q_obj.contiguous()
        ctx.counter = counter
        ctx.save_for_backward(codes, q_subj, q_obj, neg_values, coin)
        return gather_dot(codes, q_subj, q_obj, neg_values, coin, counter)

    @staticmethod
    def backward(ctx, d_energy, d_sq):
        codes, q_subj, q_obj, neg_values, coin = ctx.saved_tensors
        n, k = neg_values.shape
        d_energy = d_energy.contiguous()
        dq_subj = dq_obj = d_codes = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dq_subj, dq_obj = gather_dot_grad(codes, neg_values, coin,
                                              d_energy, ctx.counter)
        if ctx.needs_input_grad[0]:
            qcat = q_subj if coin is None else torch.cat([q_subj, q_obj])
            d_codes = _code_grads(
                codes, qcat, neg_values.reshape(-1), d_energy.reshape(-1),
                2.0 * d_sq.reshape(-1),
                _factor_rows(n, k, coin, codes.device), sum_by_csr)
        return d_codes, dq_subj, dq_obj, None, None, None


def gather_dot_reference(codes: torch.Tensor, q_subj: torch.Tensor,
                         q_obj: Optional[torch.Tensor],
                         neg_values: torch.Tensor,
                         coin: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``gather_dot``: the gathered rows [n, k, d], each
    multiplied by its selected factor (q_obj where ``coin``, else q_subj)
    and summed, and squared and summed, in the codes' dtype."""
    ev = codes[neg_values.long()]
    q = q_subj[:, None, :] if coin is None else torch.where(
        coin[:, :, None], q_obj[:, None, :], q_subj[:, None, :])
    return (ev * q).sum(-1), (ev * ev).sum(-1)


def gather_dot_grad_reference(codes: torch.Tensor,
                              neg_values: torch.Tensor,
                              coin: Optional[torch.Tensor],
                              d_energy: torch.Tensor) -> tuple:
    """Plain version of ``gather_dot_grad``: (dq_subj, dq_obj), each
    [n, d] the sum over k of its entries' cotangents times their gathered
    rows (dq_obj None where ``coin`` is None, every entry then
    q_subj's)."""
    ev = codes[neg_values.long()]
    g = d_energy.to(codes.dtype)
    if coin is None:
        return (g[:, :, None] * ev).sum(1), None
    obj = coin.to(codes.dtype)
    return (((g * (1 - obj))[:, :, None] * ev).sum(1),
            ((g * obj)[:, :, None] * ev).sum(1))


@functools.lru_cache(maxsize=None)
def kernel_library() -> tuple:
    """Build (at first use) and bind the kernels: (CDLL, nvcc.BuildInfo)."""
    lib, info = nvcc.load(_SOURCE)
    return bind_library(lib), info


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from the kernel source."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gather_dot_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, ll, i, p]
    lib.gather_dot_f32.restype = i
    lib.gather_dot_grad_f32.argtypes = [p, p, p, p, p, p, i, i, i, ll, i, p]
    lib.gather_dot_grad_f32.restype = i
    lib.gather_dot_error_string.argtypes = [i]
    lib.gather_dot_error_string.restype = ctypes.c_char_p
    return lib


def gather_dot(codes: torch.Tensor, q_subj: torch.Tensor,
               q_obj: Optional[torch.Tensor], neg_values: torch.Tensor,
               coin: Optional[torch.Tensor] = None, counter=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(energy [n, k] f32, ev_sq [n, k] f32): each corruption's row of
    ``codes`` [V, d] dotted with q_obj[n] where ``coin`` [n, k] bool is
    set, else with q_subj[n], and its sum of squares. On a CUDA tensor
    one launch of ``gather_dot_kernel`` (none for n * k = 0), counted on
    ``counter.f32_launches`` where a counter is given; on a CPU tensor
    ``gather_dot_reference``. ``neg_values``: [n, k] int64 ids in [0, V);
    without ``coin`` every entry scores against q_subj."""
    if codes.device.type == "cpu":
        return gather_dot_reference(codes, q_subj, q_obj, neg_values, coin)
    n, k = neg_values.shape
    _check(codes, neg_values, coin, {"q_subj": q_subj, "q_obj": q_obj})
    energy = torch.empty(n, k, dtype=torch.float32, device=codes.device)
    ev_sq = torch.empty_like(energy)
    lib = kernel_library()[0]
    _raise(lib, lib.gather_dot_f32(
        codes.data_ptr(), q_subj.data_ptr(), _ptr(q_obj, coin),
        neg_values.data_ptr(), _ptr(coin, coin), energy.data_ptr(),
        ev_sq.data_ptr(), n, k, codes.shape[1], codes.shape[0],
        codes.device.index, _stream(codes)))
    if counter is not None and n * k > 0:
        counter.f32_launches += 1
    return energy, ev_sq


def gather_dot_grad(codes: torch.Tensor, neg_values: torch.Tensor,
                    coin: Optional[torch.Tensor], d_energy: torch.Tensor,
                    counter=None) -> tuple:
    """(dq_subj [n, d] f32, dq_obj [n, d] f32 or None): the gradient of
    ``gather_dot``'s energies in the factors for their cotangent
    ``d_energy`` [n, k] f32, each the sum over k of its entries'
    cotangents times their rows of ``codes`` (every entry q_subj's, and
    dq_obj None, without ``coin``). On a CUDA tensor one launch of
    ``gather_dot_grad_kernel`` (none for n * k = 0: zeros), counted on
    ``counter.f32_grad_launches``; on a CPU tensor
    ``gather_dot_grad_reference``."""
    if codes.device.type == "cpu":
        return gather_dot_grad_reference(codes, neg_values, coin, d_energy)
    n, k = neg_values.shape
    _check(codes, neg_values, coin, {"d_energy": d_energy})
    alloc = codes.new_zeros if n * k == 0 else codes.new_empty
    dq_subj = alloc(n, codes.shape[1])
    dq_obj = None if coin is None else alloc(n, codes.shape[1])
    lib = kernel_library()[0]
    _raise(lib, lib.gather_dot_grad_f32(
        codes.data_ptr(), neg_values.data_ptr(), _ptr(coin, coin),
        d_energy.data_ptr(), dq_subj.data_ptr(), _ptr(dq_obj, coin), n, k,
        codes.shape[1], codes.shape[0], codes.device.index, _stream(codes)))
    if counter is not None and n * k > 0:
        counter.f32_grad_launches += 1
    return dq_subj, dq_obj


def _ptr(t: Optional[torch.Tensor], coin: Optional[torch.Tensor]):
    """A tensor's pointer where the coins are given (the kernels read the
    second factor and write its gradient only then), else null."""
    return None if coin is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        msg = lib.gather_dot_error_string(rc).decode()
        raise RuntimeError(f"gather_dot kernel launch failed: {msg} ({rc})")


def _check(codes, neg_values, coin, rows: dict) -> None:
    """Raise on anything the kernels do not take: codes [V, d] float32;
    ids [n, k] int64; the coins [n, k] bool where given; each of ``rows``
    float32, the factors [n, d] (the second only where the coins are
    given), the cotangent [n, k]; all contiguous on the codes' device."""
    if codes.dim() != 2 or neg_values.dim() != 2:
        raise ValueError(f"gather_dot: codes {tuple(codes.shape)} and ids "
                         f"{tuple(neg_values.shape)} must be 2-d")
    n, k = neg_values.shape
    tensors = {"codes": codes, "neg_values": neg_values}
    dtypes = {"codes": torch.float32, "neg_values": torch.int64}
    if coin is not None:
        tensors["corrupt_object"], dtypes["corrupt_object"] = coin, \
            torch.bool
        if coin.shape != (n, k):
            raise ValueError(f"gather_dot: coins {tuple(coin.shape)} for "
                             f"ids {(n, k)}")
    for name, t in rows.items():
        if name == "q_obj" and coin is None:
            continue
        tensors[name], dtypes[name] = t, torch.float32
        want = (n, k) if name == "d_energy" else (n, codes.shape[1])
        if t.shape != want:
            raise ValueError(f"gather_dot: {name} {tuple(t.shape)}, "
                             f"expected {want}")
    staircase.check_tensors("gather_dot", codes.device, tensors, dtypes)
    if max(n, k, codes.shape[1]) >= 2 ** 31:
        raise ValueError("gather_dot: a dimension overflows int32")
