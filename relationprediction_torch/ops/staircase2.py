"""Block-diagonal relational aggregation: the CUDA kernel and its plain form.

Counterpart of ``relationprediction_tpu/ops/staircase2.py`` (same module
name). ``block_direction`` computes

    out[v] = sum over edges e with target v of
             w_e * blockdiag(blocks[r_e]) @ features[src_e]

with ``y[b*dr + i] = sum_j blocks[r, b, i, j] * x[b*dr + j]``, over one
direction's CSR layout (graph.py). Its gradient (the JAX package's VJP,
``staircase2.py:698-783``) is

    d features[u] = sum over edges e with source u of
                    w_e * blockdiag(blocks[r_e])^T @ g[tgt_e]
    d blocks[r, b, i, j] = sum over edges e of relation r of
                    w_e * g[tgt_e, b*dr + i] * features[src_e, b*dr + j]

The first is the same kernel on the direction's twin CSR (by source, with
the direction's own weights; graph.py), reading the blocks transposed: the
"twin pass". The second is torch ops over chunks of edges.

On a CUDA tensor both kernel passes launch the kernels of
``csrc/block_direction.cu`` or raise; on a CPU tensor they run
``block_direction_reference``, the plain PyTorch version, so the CPU path
runs the same backward formulas (twin layout, twin weights, d blocks).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..device import exact_float32
from ..graph import CsrLayout
from . import nvcc

_SOURCE = "block_direction.cu"
_MAX_DR = 8


@functools.lru_cache(maxsize=None)
def kernel_library() -> tuple:
    """Build (at first use) and bind the kernel: (CDLL, nvcc.BuildInfo)."""
    lib, info = nvcc.load(_SOURCE)
    return bind_library(lib), info


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from the kernel source."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.block_direction_f32, lib.block_direction_twin_f32):
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    lib.block_direction_max_blocks.argtypes = []
    lib.block_direction_max_blocks.restype = i
    lib.block_direction_error_string.argtypes = [i]
    lib.block_direction_error_string.restype = ctypes.c_char_p
    return lib


def _row_of_edge(layout: CsrLayout) -> torch.Tensor:
    """The row (target) of every CSR entry."""
    return torch.repeat_interleave(
        torch.arange(layout.n_rows, device=layout.row_ptr.device),
        layout.row_ptr.diff().long())


def block_direction_reference(features: torch.Tensor, blocks: torch.Tensor,
                              layout: CsrLayout, n_vertices: int,
                              edge_chunk: int = 16384) -> torch.Tensor:
    """Plain PyTorch version: gather, per-edge block transform in chunks of
    edges (so [E, B, dr, dr] weights never exist at once), ``index_add_``.
    Sums in the features' dtype (float64 inputs give a float64 result)."""
    exact_float32()
    n_rel, n_blocks, dr, _ = blocks.shape
    d = n_blocks * dr
    targets = _row_of_edge(layout)
    out = torch.zeros(n_vertices, d, dtype=features.dtype,
                      device=features.device)
    for start in range(0, layout.n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        x = features[layout.src[sl].long()].view(-1, n_blocks, dr)
        w = blocks[layout.rel[sl].long()]
        y = torch.einsum("ebij,ebj->ebi", w, x).reshape(-1, d)
        out.index_add_(0, targets[sl], y * layout.w[sl, None])
    return out


def block_direction_dblocks(features: torch.Tensor, g: torch.Tensor,
                            blocks_shape, layout: CsrLayout,
                            edge_chunk: int = 16384) -> torch.Tensor:
    """d blocks [R, B, dr, dr] of one direction for the cotangent ``g`` of
    its output: per chunk of edges, the weighted outer products
    g[tgt] x[src]^T of each block, added into their relation with
    ``index_add_``. Chunks bound the [chunk, B, dr, dr] products (164 MB
    at 16,384 edges, B=100, dr=5; all 272,115 edges at once would be
    2.7 GB)."""
    exact_float32()
    n_rel, n_blocks, dr, _ = blocks_shape
    targets = _row_of_edge(layout)
    dw = torch.zeros(n_rel, n_blocks, dr, dr, dtype=torch.float32,
                     device=features.device)
    for start in range(0, layout.n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        gw = (g[targets[sl]] * layout.w[sl, None]).view(-1, n_blocks, dr)
        x = features[layout.src[sl].long()].view(-1, n_blocks, dr)
        dw.index_add_(0, layout.rel[sl].long(),
                      torch.einsum("ebi,ebj->ebij", gw, x))
    return dw


def block_direction(features: torch.Tensor, blocks: torch.Tensor,
                    layout: CsrLayout, n_vertices: int,
                    twin: Optional[CsrLayout] = None) -> torch.Tensor:
    """One direction's aggregation, differentiable; see the module
    docstring.

    features: [V, d] float32; blocks: [R, B, dr, dr] float32 (the JAX
    package's layout); layout: the direction's CSR with n_vertices rows;
    twin: its twin CSR (graph.GraphBatch.fwd_twin / bwd_twin), needed only
    for the gradient with respect to features. Returns [n_vertices, d]
    float32.
    """
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_direction: unsupported device "
                         f"{features.device}")
    return _BlockDirection.apply(features, blocks, layout, twin, n_vertices)


# Kernel launches since the counts were last set to 0, forward passes and
# twin passes apart (CPU calls never count).
block_direction.launches = 0
block_direction.twin_launches = 0


class _BlockDirection(torch.autograd.Function):
    """Forward: the kernel on ``layout``. Backward: the twin pass for
    d features, ``block_direction_dblocks`` for d blocks."""

    @staticmethod
    def forward(ctx, features, blocks, layout, twin, n_vertices):
        ctx.save_for_backward(features, blocks)
        ctx.layout, ctx.twin, ctx.n_vertices = layout, twin, n_vertices
        return _aggregate(features, blocks, layout, n_vertices, twin=False)

    @staticmethod
    def backward(ctx, g):
        features, blocks = ctx.saved_tensors
        g = g.contiguous()
        d_features = d_blocks = None
        if ctx.needs_input_grad[0]:
            if ctx.twin is None:
                raise ValueError("block_direction: the gradient with "
                                 "respect to features needs the "
                                 "direction's twin layout")
            d_features = _aggregate(g, blocks, ctx.twin, ctx.n_vertices,
                                    twin=True)
        if ctx.needs_input_grad[1]:
            d_blocks = block_direction_dblocks(features, g, blocks.shape,
                                               ctx.layout)
        return d_features, d_blocks, None, None, None


def _aggregate(features, blocks, layout, n_vertices, *, twin: bool):
    """One kernel pass: the forward (blocks as given) or the twin pass
    (blocks transposed), or their plain version for a CPU tensor."""
    if features.device.type == "cpu":
        return block_direction_reference(
            features, blocks.transpose(-1, -2) if twin else blocks, layout,
            n_vertices)
    _check(features, blocks, layout, n_vertices)
    out = launch(kernel_library()[0], features, blocks, layout, n_vertices,
                 twin=twin)
    if twin:
        block_direction.twin_launches += 1
    else:
        block_direction.launches += 1
    return out


def launch(lib: ctypes.CDLL, features: torch.Tensor, blocks: torch.Tensor,
           layout: CsrLayout, n_vertices: int, *,
           twin: bool = False) -> torch.Tensor:
    """One launch of a bound kernel library on the current stream, on
    inputs already checked; raises if the launch is refused. ``twin``
    launches the entry point that reads ``blocks`` transposed."""
    n_blocks, dr = blocks.shape[1], blocks.shape[2]
    out = torch.empty(n_vertices, n_blocks * dr, dtype=torch.float32,
                      device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    fn = lib.block_direction_twin_f32 if twin else lib.block_direction_f32
    rc = fn(features.data_ptr(), blocks.data_ptr(), layout.row_ptr.data_ptr(),
            layout.src.data_ptr(), layout.rel.data_ptr(),
            layout.w.data_ptr(), out.data_ptr(), n_vertices, n_blocks, dr,
            features.device.index, stream)
    if rc != 0:
        msg = lib.block_direction_error_string(rc).decode()
        raise RuntimeError(f"block_direction kernel launch failed: "
                           f"{msg} ({rc})")
    return out


def _check(features, blocks, layout, n_vertices) -> None:
    """Raise on anything the kernel does not take."""
    tensors = {"features": features, "blocks": blocks,
               "row_ptr": layout.row_ptr, "src": layout.src,
               "rel": layout.rel, "w": layout.w}
    dtypes = {"features": torch.float32, "blocks": torch.float32,
              "row_ptr": torch.int32, "src": torch.int32,
              "rel": torch.int32, "w": torch.float32}
    for name, t in tensors.items():
        if t.device != features.device:
            raise ValueError(f"block_direction: {name} is on {t.device}, "
                             f"features on {features.device}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"block_direction: {name} is {t.dtype}, "
                            f"expected {dtypes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"block_direction: {name} is not contiguous")
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"block_direction: blocks must be [R, B, dr, dr], "
                         f"got {tuple(blocks.shape)}")
    n_blocks, dr = blocks.shape[1], blocks.shape[2]
    lib, _ = kernel_library()
    if not 1 <= dr <= _MAX_DR or n_blocks > lib.block_direction_max_blocks():
        raise ValueError(f"block_direction: kernel takes dr in [1, "
                         f"{_MAX_DR}] and B <= "
                         f"{lib.block_direction_max_blocks()}, got "
                         f"dr={dr}, B={n_blocks}")
    if features.dim() != 2 or features.shape[1] != n_blocks * dr:
        raise ValueError(f"block_direction: features {tuple(features.shape)}"
                         f" do not match d = B*dr = {n_blocks * dr}")
    if layout.n_rows != n_vertices or features.shape[0] != n_vertices:
        raise ValueError(f"block_direction: layout has {layout.n_rows} rows "
                         f"and features {features.shape[0]}, expected "
                         f"{n_vertices}")
    e = layout.n_edges
    if layout.rel.shape[0] != e or layout.w.shape[0] != e:
        raise ValueError("block_direction: src, rel and w differ in length")
