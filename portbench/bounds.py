"""Least times of the port's hand kernels, from the work their inputs need.

Frozen copies of ``chip_smoke.py``'s bound arithmetic (``least_time``,
``block_direction_bound``, ``combine_bound``) for the kernels the cells'
metrics read, so that a later edit of ``chip_smoke.py`` or of the
port does not move the benchmark. Each input is counted as read once and
the output as written once, from the layout's own counts; the least time is
the larger of bytes over the HBM rate and operations over the arithmetic
rate. ``project_bound`` is restated as the product's own work (2 M K N) at
the f32-exact rate of the tensor cores (the TF32 peak over 3), whatever
route a kernel takes to it. A layout is any object with ``row_ptr``,
``src`` and ``rel`` tensors (the port's ``graph.CsrLayout``).
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# A float32 product that keeps float32's accuracy on the tensor cores takes
# three TF32 products (the split into a high and a low part).
F32_EXACT_TENSOR_OPS_PER_S = TF32_OPS_PER_S / 3


def least_time(n_bytes, ops, ops_per_s=F32_OPS_PER_S) -> dict:
    """The least time for ``n_bytes`` of HBM traffic and ``ops``
    operations at ``ops_per_s``: the larger of the two, and which it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bytes": n_bytes, "ops": ops,
            "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _edges(layout) -> int:
    return int(layout.src.shape[0])


def _unique(t) -> int:
    return int(torch.unique(t).numel())


def block_direction_bound(layout, n_vertices, n_blocks, dr, elem=4) -> dict:
    """One block-diagonal aggregation launch on ``layout``: the feature rows
    its edges gather and the blocks of the relations it holds (``elem``
    bytes an element), the output, weights and CSR (4 bytes), against
    2 E d operations for the weighted sums and one block product (2 d dr)
    per (target, relation) run."""
    e, d = _edges(layout), n_blocks * dr
    if e == 0:
        return least_time(4 * (n_vertices * d + n_vertices + 1), 0)
    rows, rels = _unique(layout.src), _unique(layout.rel)
    n_bytes = elem * (rows * d + rels * n_blocks * dr * dr) \
        + 4 * (n_vertices * d + (n_vertices + 1) + 3 * e)
    targets = torch.repeat_interleave(
        torch.arange(n_vertices, device=layout.row_ptr.device),
        layout.row_ptr.diff().long())
    runs = int(1 + ((targets.diff() != 0) | (layout.rel.diff() != 0))
               .sum().item())
    return least_time(n_bytes, 2 * e * d + 2 * runs * d * dr)


def project_bound(m, k, n) -> dict:
    """The product X [M, K] @ W [K, N] in float32: read X and W, write P,
    against its own 2 M K N operations at the f32-exact tensor-core rate
    (a product that keeps float32's accuracy, such as the 3xTF32 split
    the port's ``basis_project`` takes, or any other route to it)."""
    n_bytes = 4 * (m * k + k * n + m * n)
    return least_time(n_bytes, 2 * m * k * n, F32_EXACT_TENSOR_OPS_PER_S)


def combine_bound(layout, n_rows, n_bases, d_out, elem=4) -> dict:
    """basis_combine on ``layout``: each gathered projected row (B d_out
    elements of ``elem`` bytes) once, the coefficients of the relations
    present, the CSR, the output written once, against 2 E B d_out + E B
    operations."""
    e = _edges(layout)
    rows = _unique(layout.src) if e else 0
    rels = _unique(layout.rel) if e else 0
    n_bytes = elem * rows * n_bases * d_out + 4 * (
        n_rows * d_out + rels * n_bases + (n_rows + 1) + 3 * e)
    return least_time(n_bytes, 2 * e * n_bases * d_out + e * n_bases)
