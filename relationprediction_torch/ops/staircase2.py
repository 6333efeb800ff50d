"""Block-diagonal relational aggregation: the CUDA kernel and its plain form.

Counterpart of ``relationprediction_tpu/ops/staircase2.py`` (same module
name). ``block_direction`` computes

    out[v] = sum over edges e with target v of
             w_e * blockdiag(blocks[r_e]) @ features[src_e]

with ``y[b*dr + i] = sum_j blocks[r, b, i, j] * x[b*dr + j]``, over one
direction's CSR layout (graph.py). On a CUDA tensor it launches the kernel
of ``csrc/block_direction.cu`` or raises; on a CPU tensor it runs
``block_direction_reference``, the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools

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
    lib.block_direction_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.block_direction_f32.restype = i
    lib.block_direction_max_blocks.argtypes = []
    lib.block_direction_max_blocks.restype = i
    lib.block_direction_error_string.argtypes = [i]
    lib.block_direction_error_string.restype = ctypes.c_char_p
    return lib


def block_direction_reference(features: torch.Tensor, blocks: torch.Tensor,
                              layout: CsrLayout, n_vertices: int,
                              edge_chunk: int = 16384) -> torch.Tensor:
    """Plain PyTorch version: gather, per-edge block transform in chunks of
    edges (so [E, B, dr, dr] weights never exist at once), ``index_add_``."""
    exact_float32()
    n_rel, n_blocks, dr, _ = blocks.shape
    d = n_blocks * dr
    targets = torch.repeat_interleave(
        torch.arange(layout.n_rows, device=features.device),
        layout.row_ptr.diff().long())
    out = torch.zeros(n_vertices, d, dtype=torch.float32,
                      device=features.device)
    for start in range(0, layout.n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        x = features[layout.src[sl].long()].view(-1, n_blocks, dr)
        w = blocks[layout.rel[sl].long()]
        y = torch.einsum("ebij,ebj->ebi", w, x).reshape(-1, d)
        out.index_add_(0, targets[sl], y * layout.w[sl, None])
    return out


def block_direction(features: torch.Tensor, blocks: torch.Tensor,
                    layout: CsrLayout, n_vertices: int) -> torch.Tensor:
    """One direction's aggregation; see the module docstring.

    features: [V, d] float32; blocks: [R, B, dr, dr] float32 (the JAX
    package's layout); layout: the direction's CSR with n_vertices rows.
    Returns [n_vertices, d] float32.
    """
    if features.device.type == "cpu":
        return block_direction_reference(features, blocks, layout,
                                          n_vertices)
    if features.device.type != "cuda":
        raise ValueError(f"block_direction: unsupported device "
                         f"{features.device}")
    _check(features, blocks, layout, n_vertices)
    out = launch(kernel_library()[0], features, blocks, layout, n_vertices)
    block_direction.launches += 1
    return out


# Kernel launches since the count was last set to 0 (CPU calls never count).
block_direction.launches = 0


def launch(lib: ctypes.CDLL, features: torch.Tensor, blocks: torch.Tensor,
           layout: CsrLayout, n_vertices: int) -> torch.Tensor:
    """One launch of a bound kernel library on the current stream, on
    inputs already checked; raises if the launch is refused."""
    n_blocks, dr = blocks.shape[1], blocks.shape[2]
    out = torch.empty(n_vertices, n_blocks * dr, dtype=torch.float32,
                      device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.block_direction_f32(
        features.data_ptr(), blocks.data_ptr(), layout.row_ptr.data_ptr(),
        layout.src.data_ptr(), layout.rel.data_ptr(), layout.w.data_ptr(),
        out.data_ptr(), n_vertices, n_blocks, dr, features.device.index,
        stream)
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
