"""Relational aggregation of one direction: the CUDA kernels and their plain
forms, for the block-diagonal (``block_direction``) and the
basis-decomposition (``basis_direction``) R-GCN layers.

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

On a CUDA tensor both kernel passes launch the kernel of
``csrc/block_direction.cu`` (a merge-path partition of row ends and
entries over equal thread blocks, then its carry fix-up; the partition is
``staircase.merge_path_split``) or raise; on a CPU tensor they run
``block_direction_reference``, the plain PyTorch version, so the CPU path
runs the same backward formulas (twin layout, twin weights, d blocks).

``basis_direction`` (the JAX package's ``staircase2.py:804-897``) computes

    out[v] = sum over edges e with target v of
             w_e * sum_b C[r_e, b] * (features[src_e] @ W_b)

with ``W_flat`` [d_in, B*d_out] (W_b its columns b*d_out..(b+1)*d_out) and
C [R, B], as two kernels: ``basis_project`` (P = features @ W_flat, once
per vertex, in 3xTF32 on the tensor cores after a split pass;
``csrc/basis_project.cu``) and ``basis_combine`` (per target row, sum over
its edges of w_e * sum_b C[r_e, b] * P[src_e, b, :];
``csrc/basis_direction.cu``, on the same merge-path partition). Its
gradient is

    d features = basis_combine(g @ w_t, C, twin)   (the twin pass)
    d W_flat[i, b*d_out + o] = sum over edges e of
                w_e * C[r_e, b] * features[src_e, i] * g[tgt_e, o]
    d C[r, b] = sum over edges e of relation r of
                w_e * <P[src_e, b, :], g[tgt_e]>

with ``w_t`` [d_out, B*d_in], w_t[o, b*d_in + i] = W_flat[i, b*d_out + o],
the per-basis transposed stacks (``staircase2.py:859-861``). The last two
are torch ops over chunks of edges (``basis_direction_dweights``).

``scatter2`` and ``scatter2_slot_order`` (the JAX package's
``staircase2.py:639-661``, TPU kernel 4) are the plain weighted scatter;
they run the kernel of ``ops/staircase.py`` (``csrc/staircase.cu``).

bf16 message precision (the JAX ops' ``compute_dtype``): with
``compute_dtype=torch.bfloat16`` each op sends its gathered table and its
weights operand to the bf16 entry point of its kernel
(``block_direction_bf16`` and ``block_direction_twin_bf16``: features or
g and the blocks, by the slice route where W's slice fits a thread
block's shared memory, ``block_direction_route``, else by the walk;
``basis_project_bf16``, after a pad pass that lays them
out K-major for TMA: x or g and W_flat or w_t, P written in bf16;
``basis_combine_bf16``: P, its words held until the FMA so that more
thread blocks an SM keep gathers in flight, by the column chunks of
``staircase.basis_combine_plan``), which widens them to f32:
edge weights and C stay f32, products and sums are f32, outputs f32 but
P. The JAX kernels round more (the weighted rows, the per-edge products,
the sum over the bases in bf16). d blocks, d W_flat and d C stay f32
torch ops on the saved f32 inputs (d C from an f32 P, made by the f32
basis_project kernel), as the JAX VJPs compute them on the CPU
(``staircase2.py:736-740``, ``:877-893``). A bf16 CUDA tensor launches a bf16 kernel or raises; each plain version
upcasts bf16 and computes in f32 (``basis_project_reference`` then
rounds P to bf16), so on the card a kernel and its plain version differ
only in the order of their f32 sums.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..device import exact_float32
from ..graph import CsrLayout
from . import nvcc, staircase
from .gather import add_by_id
from .staircase import check_tensors, input_dtype, upcast_bf16

_SOURCE = "block_direction.cu"
_BASIS_SOURCE = "basis_direction.cu"
_PROJECT_SOURCE = "basis_project.cu"
_MAX_DR = 8
_EDGE_CHUNK = 16384
# The bf16 slice route (csrc/block_direction.cu): the shared memory a
# thread block may have on an H100 (cudaDevAttrMaxSharedMemoryPerBlockOptin,
# 227 KB), and the lanes a walker may have (its kernel's
# block_direction_slice_min_lanes and a warp); the kernel checks both.
SLICE_SMEM_BUDGET = 232448
SLICE_LANES = (4, 32)


@dataclasses.dataclass(frozen=True)
class BlockRoute:
    """How block_direction's bf16 entry points run for R relations of B
    blocks of dr x dr: ``route`` "slice" (thread block y serves output
    blocks [y * blocks_per_slice, ...) of ``n_slices``, W's slice of
    ``smem_bytes`` in shared memory, walkers of ``lanes`` lanes) or "walk"
    (the merge-path walk, W read from L2 each relation run; the other fields
    0)."""

    route: str
    blocks_per_slice: int = 0
    lanes: int = 0
    n_slices: int = 0
    smem_bytes: int = 0

    def slices(self, n_blocks: int) -> list:
        """(first, end) output blocks of each slice."""
        bs = self.blocks_per_slice
        return [(s * bs, min((s + 1) * bs, n_blocks))
                for s in range(self.n_slices)]


def slice_threads(dr: int) -> int:
    """Threads of a slice thread block (block_direction.cu's
    slice_threads): 1024 up to dr = 6, 512 above."""
    return 1024 if dr <= 6 else 512


def slice_smem_bytes(n_rel: int, blocks_per_slice: int, dr: int) -> int:
    """Shared memory of a slice launch, as block_direction.cu lays it out:
    a region a relation of ceil((2 * bs * dr * dr + 14) / 16) 16-byte
    chunks, the chunks of W that hold its bf16 values (they start at any
    even byte of a chunk), then the CSR staging: each walker's windows of
    row ends and entries, 16 bytes a thread."""
    return 16 * (n_rel * ((2 * blocks_per_slice * dr * dr + 29) // 16)
                 + slice_threads(dr))


@functools.lru_cache(maxsize=None)
def block_direction_route(n_rel: int, n_blocks: int, dr: int) -> BlockRoute:
    """The bf16 route for these shapes, from the shapes alone: the slice
    route where a slice of at least one block fits SLICE_SMEM_BUDGET, else
    the walk. The slice takes as many blocks as fit (at most a warp's 32);
    the walker's lanes are a power of two >= those blocks (at least 4),
    or 16 where a warp of lanes would idle more of them; the slices are
    then evened out (FB15k-237, R = 237 at B = 100, dr = 5: 7 slices of
    15 and 10 blocks, 16 lanes, 198,400 bytes)."""
    least, most = SLICE_LANES
    cap = next((bs for bs in range(min(most, n_blocks), 0, -1)
                if slice_smem_bytes(n_rel, bs, dr) <= SLICE_SMEM_BUDGET), 0)
    if cap == 0:
        return BlockRoute("walk")

    def plan(lanes):
        n_slices = -(-n_blocks // min(cap, lanes))
        bs = -(-n_blocks // n_slices)
        lanes = max(least, 1 << (bs - 1).bit_length())
        return (n_slices * lanes, -lanes), BlockRoute(
            "slice", bs, lanes, n_slices, slice_smem_bytes(n_rel, bs, dr))
    first = max(least, 1 << (cap - 1).bit_length())
    return min((plan(lanes) for lanes in
                ([first, most // 2] if first == most else [first])),
               key=lambda p: p[0])[1]


@functools.lru_cache(maxsize=None)
def kernel_library() -> tuple:
    """Build (at first use) and bind the kernel: (CDLL, nvcc.BuildInfo)."""
    lib, info = nvcc.load(_SOURCE)
    return bind_library(lib), info


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from the kernel source."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.block_direction_f32, lib.block_direction_twin_f32,
               lib.block_direction_bf16, lib.block_direction_twin_bf16):
        fn.argtypes = [p] * 9 + [i] * 6 + [p]
        fn.restype = i
    for fn in (lib.block_direction_slice_bf16,
               lib.block_direction_twin_slice_bf16):
        fn.argtypes = [p] * 9 + [i] * 9 + [p]
        fn.restype = i
    for fn in (lib.block_direction_max_blocks, lib.block_direction_max_items,
               lib.block_direction_slice_min_lanes):
        fn.argtypes = []
        fn.restype = i
    lib.block_direction_slice_threads.argtypes = [i]
    lib.block_direction_slice_threads.restype = i
    lib.block_direction_slice_smem_bytes.argtypes = [i, i, i]
    lib.block_direction_slice_smem_bytes.restype = ll
    lib.block_direction_slice_chunks.argtypes = [i] * 9
    lib.block_direction_slice_chunks.restype = ll
    lib.block_direction_slice_registers.argtypes = [i, i]
    lib.block_direction_slice_registers.restype = i
    lib.block_direction_error_string.argtypes = [i]
    lib.block_direction_error_string.restype = ctypes.c_char_p
    return lib


def block_direction_reference(features: torch.Tensor, blocks: torch.Tensor,
                              layout: CsrLayout, n_vertices: int,
                              edge_chunk: int = _EDGE_CHUNK) -> torch.Tensor:
    """Plain PyTorch version: gather, per-edge block transform in chunks of
    edges (so [E, B, dr, dr] weights never exist at once), ``index_add_``.
    Sums in the features' dtype (float64 inputs give a float64 result; bf16
    inputs are upcast and summed in float32)."""
    exact_float32()
    features, blocks = upcast_bf16(features), upcast_bf16(blocks)
    n_rel, n_blocks, dr, _ = blocks.shape
    d = n_blocks * dr
    targets = staircase.row_of_entry(layout)
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
                            edge_chunk: int = _EDGE_CHUNK) -> torch.Tensor:
    """d blocks [R, B, dr, dr] of one direction for the cotangent ``g`` of
    its output: per chunk of edges, the weighted outer products
    g[tgt] x[src]^T of each block, added into their relation by
    ``gather.add_by_id`` (``index_add_`` on the CPU; on the card kernel 3
    over the chunk's CSR by relation, no atomics), chunk after chunk.
    Chunks bound the [chunk, B, dr, dr] products (164 MB at 16,384 edges,
    B=100, dr=5; all 272,115 edges at once would be 2.7 GB)."""
    exact_float32()
    n_rel, n_blocks, dr, _ = blocks_shape
    targets = staircase.row_of_entry(layout)
    dw = torch.zeros(n_rel, n_blocks, dr, dr, dtype=torch.float32,
                     device=features.device)
    for start in range(0, layout.n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        gw = (g[targets[sl]] * layout.w[sl, None]).view(-1, n_blocks, dr)
        x = features[layout.src[sl].long()].view(-1, n_blocks, dr)
        add_by_id(dw, layout.rel[sl], torch.einsum("ebi,ebj->ebij", gw, x))
    return dw


def block_direction(features: torch.Tensor, blocks: torch.Tensor,
                    layout: CsrLayout, n_vertices: int,
                    twin: Optional[CsrLayout] = None,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """One direction's aggregation, differentiable; see the module
    docstring.

    features: [S, d] float32, S the layout's ``source_rows`` (V on a
    graph's square layouts); blocks: [R, B, dr, dr] float32 (the JAX
    package's layout); layout: the direction's CSR with n_vertices rows;
    twin: its twin CSR (graph.GraphBatch.fwd_twin / bwd_twin: S rows
    gathering from n_vertices), needed only for the gradient with respect
    to features; compute_dtype: None, or torch.bfloat16 for the bf16
    kernels. Returns [n_vertices, d] float32.
    """
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_direction: unsupported device "
                         f"{features.device}")
    return _BlockDirection.apply(features, blocks, layout, twin, n_vertices,
                                 compute_dtype)


# Kernel launches since the counts were last set to 0, forward passes and
# twin passes apart, f32 and bf16 apart, and the carry fix-up that follows
# each of them (CPU calls never count); the bf16 launches also by route,
# forward and twin apart: the slice kernel or the walk.
block_direction.launches = 0
block_direction.twin_launches = 0
block_direction.bf16_launches = 0
block_direction.bf16_twin_launches = 0
block_direction.bf16_slice_launches = 0
block_direction.bf16_twin_slice_launches = 0
block_direction.bf16_walk_launches = 0
block_direction.bf16_twin_walk_launches = 0
block_direction.fixup_launches = 0


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


class _BlockDirection(torch.autograd.Function):
    """Forward: the kernel on ``layout`` (features and blocks cast to
    ``compute_dtype`` where it is given). Backward: the twin pass for
    d features (g and the blocks cast likewise), ``block_direction_dblocks``
    on the saved f32 inputs for d blocks."""

    @staticmethod
    def forward(ctx, features, blocks, layout, twin, n_vertices,
                compute_dtype=None):
        ctx.save_for_backward(features, blocks)
        ctx.layout, ctx.twin = layout, twin
        ctx.compute_dtype = compute_dtype
        return _aggregate(_cast(features, compute_dtype),
                          _cast(blocks, compute_dtype), layout, n_vertices,
                          twin=False)

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
            # The twin sums into the rows of ``features``, which a
            # rectangular layout (a vertex shard's) has more or fewer of
            # than the forward's n_vertices.
            cd = ctx.compute_dtype
            d_features = _aggregate(_cast(g, cd), _cast(blocks, cd),
                                    ctx.twin, features.shape[0], twin=True)
        if ctx.needs_input_grad[1]:
            d_blocks = block_direction_dblocks(features, g, blocks.shape,
                                               ctx.layout)
        return d_features, d_blocks, None, None, None, None


def _aggregate(features, blocks, layout, n_vertices, *, twin: bool):
    """One kernel pass: the forward (blocks as given) or the twin pass
    (blocks transposed), f32 or bf16 by the inputs' dtype (bf16 by the
    route ``kernel_route`` gives), or their plain version for a CPU
    tensor."""
    if features.device.type == "cpu":
        return block_direction_reference(
            features, blocks.transpose(-1, -2) if twin else blocks, layout,
            n_vertices)
    _check(features, blocks, layout, n_vertices)
    out = launch(kernel_library()[0], features, blocks, layout, n_vertices,
                 twin=twin)
    bf16 = "bf16_" if features.dtype == torch.bfloat16 else ""
    name = f"{bf16}twin_launches" if twin else f"{bf16}launches"
    setattr(block_direction, name, getattr(block_direction, name) + 1)
    if bf16:
        name = (f"bf16_{'twin_' if twin else ''}"
                f"{kernel_route(features, blocks)}_launches")
        setattr(block_direction, name, getattr(block_direction, name) + 1)
    block_direction.fixup_launches += 1
    return out


def kernel_route(features: torch.Tensor, blocks: torch.Tensor) -> str:
    """The kernel ``launch`` runs by default: "walk" for f32, the bf16
    inputs' ``block_direction_route`` otherwise."""
    if features.dtype != torch.bfloat16:
        return "walk"
    return block_direction_route(*blocks.shape[:3]).route


def _carry_buffers(n_rows: int, n_edges: int, items: int, width: int,
                   max_items: int, device) -> tuple:
    """(carry_rows int32 [n_blocks], carry f32 [n_blocks, width]), the
    scratch of a merge-path launch of ``items`` items a block; raises
    beyond the kernel's ``max_items``."""
    if items > max_items:
        raise ValueError(f"merge path: kernel takes items <= {max_items}, "
                         f"got {items}")
    n_grid = staircase.merge_path_blocks(n_rows, n_edges, items)
    return (torch.empty(n_grid, dtype=torch.int32, device=device),
            torch.empty(n_grid, width, dtype=torch.float32, device=device))


def launch(lib: ctypes.CDLL, features: torch.Tensor, blocks: torch.Tensor,
           layout: CsrLayout, n_vertices: int, *, twin: bool = False,
           items: Optional[int] = None, carries: bool = False,
           route: Optional[str] = None):
    """One call of a bound kernel library (the merge-path kernel, then its
    carry fix-up) on the current stream, on inputs already checked; raises
    if a launch is refused. ``twin`` launches the entry point that reads
    ``blocks`` transposed; bf16 ``features`` and ``blocks`` the bf16 entry
    points, by ``route`` ("slice" or "walk"; by default ``kernel_route``,
    which the main path takes: ``route`` is for timing one route against
    the other, and "slice" raises where the plan has none). Returns
    ``out``, or (out, carry_rows) with ``carries`` (see
    ``staircase.merge_path_carry_rows``). ``items`` defaults to
    ``staircase.block_direction_items``."""
    n_rel, n_blocks, dr = blocks.shape[:3]
    bf16 = features.dtype == torch.bfloat16
    plan = block_direction_route(n_rel, n_blocks, dr) if bf16 else None
    route = route or kernel_route(features, blocks)
    if route not in ("slice", "walk") or (route == "slice" and (
            plan is None or plan.route != "slice")):
        raise ValueError(f"block_direction: no {route!r} route for "
                         f"{features.dtype} inputs with R={n_rel}, "
                         f"B={n_blocks}, dr={dr}")
    if items is None:
        items = staircase.block_direction_items(n_vertices, layout.n_edges)
    carry_rows, carry = _carry_buffers(
        n_vertices, layout.n_edges, items, n_blocks * dr,
        lib.block_direction_max_items(), features.device)
    out = torch.empty(n_vertices, n_blocks * dr, dtype=torch.float32,
                      device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    args = (features.data_ptr(), blocks.data_ptr(),
            layout.row_ptr.data_ptr(), layout.src.data_ptr(),
            layout.rel.data_ptr(), layout.w.data_ptr(), out.data_ptr(),
            carry_rows.data_ptr(), carry.data_ptr(), n_vertices,
            layout.n_edges, n_blocks, dr)
    if route == "slice":
        if blocks.data_ptr() % 16:
            raise ValueError("block_direction: the slice route copies the "
                             "bf16 blocks in 16-byte chunks; they do not "
                             "start on one")
        fn = lib.block_direction_twin_slice_bf16 if twin \
            else lib.block_direction_slice_bf16
        rc = fn(*args, n_rel, items, plan.blocks_per_slice, plan.lanes,
                features.device.index, stream)
    else:
        if bf16:
            fn = lib.block_direction_twin_bf16 if twin \
                else lib.block_direction_bf16
        else:
            fn = lib.block_direction_twin_f32 if twin \
                else lib.block_direction_f32
        rc = fn(*args, items, features.device.index, stream)
    if rc != 0:
        msg = lib.block_direction_error_string(rc).decode()
        raise RuntimeError(f"block_direction kernel launch failed: "
                           f"{msg} ({rc})")
    return (out, carry_rows) if carries else out


def _csr_tensors(layout: CsrLayout) -> tuple:
    """(tensors, dtypes) of a CSR layout, for ``check_tensors``."""
    return ({"row_ptr": layout.row_ptr, "src": layout.src,
             "rel": layout.rel, "w": layout.w},
            {"row_ptr": torch.int32, "src": torch.int32,
             "rel": torch.int32, "w": torch.float32})


def _check(features, blocks, layout, n_vertices) -> None:
    """Raise on anything the kernel does not take."""
    tensors, dtypes = _csr_tensors(layout)
    dtype = input_dtype("block_direction", features, blocks)
    check_tensors("block_direction", features.device,
                   {"features": features, "blocks": blocks, **tensors},
                   {"features": dtype, "blocks": dtype, **dtypes})
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
    if layout.n_rows != n_vertices:
        raise ValueError(f"block_direction: layout has {layout.n_rows} rows, "
                         f"expected {n_vertices}")
    if features.shape[0] != layout.source_rows:
        raise ValueError(f"block_direction: features have "
                         f"{features.shape[0]} rows, the layout gathers "
                         f"from {layout.source_rows}")
    e = layout.n_edges
    if layout.rel.shape[0] != e or layout.w.shape[0] != e:
        raise ValueError("block_direction: src, rel and w differ in length")


# ---------------------------------------------------------------------------
# basis_direction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def basis_kernel_library() -> tuple:
    """Build (at first use) and bind basis_combine: (CDLL,
    nvcc.BuildInfo)."""
    lib, info = nvcc.load(_BASIS_SOURCE)
    return bind_basis_library(lib), info


@functools.lru_cache(maxsize=None)
def project_kernel_library() -> tuple:
    """Build (at first use) and bind basis_project and its split pass:
    (CDLL, nvcc.BuildInfo)."""
    lib, info = nvcc.load(_PROJECT_SOURCE)
    return bind_project_library(lib), info


def bind_project_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from the project
    source."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tf32_split_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.tf32_split_f32.restype = i
    lib.basis_project_f32.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.basis_project_f32.restype = i
    lib.basis_project_bf16.argtypes = [p, p, p, i, i, i, i, p]
    lib.basis_project_bf16.restype = i
    lib.bf16_pad.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.bf16_pad.restype = i
    for fn in (lib.basis_project_bf16_k_pad, lib.basis_project_bf16_stages,
               lib.basis_project_bf16_registers):
        fn.argtypes = []
        fn.restype = i
    lib.basis_project_k_tile.argtypes = []
    lib.basis_project_k_tile.restype = i
    lib.basis_project_parts.argtypes = [i]
    lib.basis_project_parts.restype = i
    lib.basis_project_error_string.argtypes = [i]
    lib.basis_project_error_string.restype = ctypes.c_char_p
    return lib


def bind_basis_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from the basis source."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.basis_combine_f32, lib.basis_combine_row_bf16):
        fn.argtypes = [p] * 9 + [i] * 6 + [p]
        fn.restype = i
    lib.basis_combine_bf16.argtypes = [p] * 9 + [i] * 8 + [p]
    lib.basis_combine_bf16.restype = i
    for fn in (lib.basis_direction_max_bases, lib.basis_combine_max_items,
               lib.basis_combine_chunk_threads, lib.basis_combine_word_cols):
        fn.argtypes = []
        fn.restype = i
    lib.basis_combine_chunk_smem_bytes.argtypes = [i, i]
    lib.basis_combine_chunk_smem_bytes.restype = ctypes.c_longlong
    lib.basis_direction_error_string.argtypes = [i]
    lib.basis_direction_error_string.restype = ctypes.c_char_p
    return lib


def basis_project_reference(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version of ``basis_project``: x @ w in full float32 (or in the
    inputs' dtype); bf16 inputs are upcast, multiplied in float32 and the
    product rounded to bf16, as ``basis_project_bf16`` stores it."""
    exact_float32()
    if x.dtype == torch.bfloat16:
        return torch.matmul(x.float(), w.float()).to(torch.bfloat16)
    return torch.matmul(x, w)


def bf16_pad_reference(x: torch.Tensor, w: torch.Tensor, kp: int) -> tuple:
    """Plain version of the bf16 pad pass: (xp [m, kp], wt [n, kp]), x
    [m, k] and w [k, n] transposed, K-major, columns k .. kp - 1 zero."""
    (m, k), n = x.shape, w.shape[1]
    xp = x.new_zeros(m, kp)
    xp[:, :k] = x
    wt = w.new_zeros(n, kp)
    wt[:, :k] = w.t()
    return xp, wt


def tf32_rna_reference(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, on its bits, as ``cvt.rna.tf32.f32``: the low 13
    mantissa bits become 0. Inf and NaN pass through."""
    bits = a.contiguous().view(torch.int32)
    magnitude = bits & 0x7FFFFFFF
    rounded = (magnitude + 0x1000) & ~0x1FFF
    special = magnitude >= 0x7F800000
    out = torch.where(special, bits, (bits & ~0x7FFFFFFF) | rounded)
    return out.view(torch.float32)


def tf32_split_reference(a: torch.Tensor, parts: int = 2) -> tuple:
    """Plain version of the split pass: ``parts`` TF32 parts of ``a``,
    a_0 = tf32_rna(a), a_1 = tf32_rna(a - a_0), a_2 = tf32_rna(a - a_0 -
    a_1). a_0 + a_1 holds ~22 bits of ``a`` (within 2^-22 |a|); with a_2
    the sum is ``a`` exactly (normal floats). The kernel writes them
    K-major and zero-padded (``launch_split``)."""
    out, rest = [], a
    for _ in range(parts):
        out.append(tf32_rna_reference(rest))
        rest = rest - out[-1]
    return tuple(out)


def basis_combine_reference(proj: torch.Tensor, coefficients: torch.Tensor,
                            layout: CsrLayout, n_rows: int,
                            edge_chunk: int = _EDGE_CHUNK) -> torch.Tensor:
    """Plain version of ``basis_combine``: per chunk of edges, gather the
    projected rows [e, B, d_out], weight them by w_e * C[r_e, b], sum over
    b and ``index_add_`` into the rows. Sums in ``proj``'s dtype (bf16
    upcast to float32)."""
    proj = upcast_bf16(proj)
    n_bases = coefficients.shape[1]
    d_out = proj.shape[1] // n_bases
    rows = staircase.row_of_entry(layout)
    out = torch.zeros(n_rows, d_out, dtype=proj.dtype, device=proj.device)
    for start in range(0, layout.n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        p = proj[layout.src[sl].long()].view(-1, n_bases, d_out)
        c = (coefficients[layout.rel[sl].long()]
             * layout.w[sl, None]).to(proj.dtype)
        out.index_add_(0, rows[sl], torch.einsum("eb,ebo->eo", c, p))
    return out


def basis_direction_reference(features: torch.Tensor, w_flat: torch.Tensor,
                              coefficients: torch.Tensor, layout: CsrLayout,
                              n_vertices: int) -> torch.Tensor:
    """Plain version of one direction: project, then combine."""
    return basis_combine_reference(
        basis_project_reference(features, w_flat), coefficients, layout,
        n_vertices)


def basis_twin_weights(w_flat: torch.Tensor, n_bases: int) -> torch.Tensor:
    """The per-basis transposed stacks [d_out, B*d_in] of ``w_flat``
    [d_in, B*d_out] (``staircase2.py:859-861``): basis-major, then input
    feature. A layout copy, not a product."""
    d_in = w_flat.shape[0]
    d_out = w_flat.shape[1] // n_bases
    return w_flat.reshape(d_in, n_bases, d_out).permute(2, 1, 0) \
        .reshape(d_out, n_bases * d_in).contiguous()


def basis_direction_dweights(features: torch.Tensor, proj: torch.Tensor,
                             g: torch.Tensor, coefficients: torch.Tensor,
                             layout: CsrLayout, *, need_w: bool = True,
                             need_c: bool = True,
                             edge_chunk: int = _EDGE_CHUNK) -> tuple:
    """(d W_flat [d_in, B*d_out] or None, d C [R, B] or None) of one
    direction for the cotangent ``g`` of its output, from the forward's
    projection ``proj`` = features @ W_flat. Per chunk of edges: d W_flat
    += features[src]^T @ (w_e C[r_e, b] g[tgt_e]) [e, B*d_out], one GEMM;
    d C gets <P[src_e, b, :], w_e g[tgt_e]> added into its relation by
    ``gather.add_by_id``, chunk after chunk, as d blocks' sums. Chunks
    bound the [chunk, B*d_out] operands (164 MB each at 16,384 edges,
    B=5, d=500; all 272,115 edges at once would be 2.7 GB)."""
    exact_float32()
    n_bases = coefficients.shape[1]
    d_out = g.shape[1]
    targets = staircase.row_of_entry(layout)
    dw = torch.zeros(features.shape[1], n_bases * d_out,
                     dtype=torch.float32, device=g.device) if need_w else None
    dc = torch.zeros_like(coefficients) if need_c else None
    for start in range(0, layout.n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        src = layout.src[sl].long()
        rel = layout.rel[sl].long()
        gw = g[targets[sl]] * layout.w[sl, None]
        if need_w:
            h = (coefficients[rel][:, :, None] * gw[:, None, :]) \
                .reshape(-1, n_bases * d_out)
            dw.addmm_(features[src].t(), h)
        if need_c:
            dots = torch.bmm(proj[src].view(-1, n_bases, d_out),
                             gw[:, :, None]).squeeze(-1)
            add_by_id(dc, rel, dots)
    return dw, dc


def basis_direction(features: torch.Tensor, w_flat: torch.Tensor,
                    coefficients: torch.Tensor, layout: CsrLayout,
                    n_vertices: int, twin: Optional[CsrLayout] = None,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """One basis direction, differentiable; see the module docstring.

    features: [S, d_in] float32, S the layout's ``source_rows``; w_flat:
    [d_in, B*d_out] float32; coefficients: [R, B] float32; layout: the
    direction's CSR with n_vertices rows; twin: its twin CSR (S rows
    gathering from n_vertices), needed only for the gradient with respect
    to features; compute_dtype: None, or torch.bfloat16 for the bf16
    kernels. Returns [n_vertices, d_out] float32.
    """
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"basis_direction: unsupported device "
                         f"{features.device}")
    return _BasisDirection.apply(features, w_flat, coefficients, layout,
                                 twin, n_vertices, compute_dtype)


# Kernel launches since the counts were last set to 0 (CPU calls never
# count), f32 and bf16 apart: basis_combine in forward passes and in twin
# passes (the bf16 ones also by route), the carry fix-up after each of
# them (both precisions), and basis_project in both (one before each
# combine), each f32 launch after one launch of its split pass, each bf16
# launch after one launch of its pad pass.
basis_direction.launches = 0
basis_direction.twin_launches = 0
basis_direction.bf16_chunk_launches = 0
basis_direction.bf16_twin_chunk_launches = 0
basis_direction.bf16_row_launches = 0
basis_direction.bf16_twin_row_launches = 0
basis_direction.fixup_launches = 0
basis_direction.project_launches = 0
basis_direction.split_launches = 0
basis_direction.bf16_launches = 0
basis_direction.bf16_twin_launches = 0
basis_direction.bf16_project_launches = 0
basis_direction.bf16_pad_launches = 0


def launch_counts() -> tuple:
    """(forward, twin) aggregation launches of the model's ops so far, f32
    and bf16 together: a layer direction is one forward launch of
    ``block_direction``, one ``basis_combine`` launch or one
    ``staircase.staircase_aggregate`` launch, and its gradient one twin
    launch (none for ``staircase_aggregate``, whose gradient is a torch
    gather)."""
    ops = (block_direction, basis_direction, staircase.staircase_aggregate)
    return (sum(op.launches + op.bf16_launches for op in ops),
            sum(op.twin_launches + op.bf16_twin_launches
                for op in ops[:2]))


class _BasisDirection(torch.autograd.Function):
    """Forward: project, then combine on ``layout`` (features and W_flat
    cast to ``compute_dtype`` where it is given); an f32 P is kept for
    d C. Backward: the twin pass (project g by w_t, both cast likewise,
    combine on the twin CSR) for d features, ``basis_direction_dweights``
    on the saved f32 inputs for d W_flat and d C. In bf16 the forward's P
    is bf16, so d C's f32 P is computed anew where d C is asked for, by
    the f32 path of ``_project`` (the split pass and basis_project on the
    card)."""

    @staticmethod
    def forward(ctx, features, w_flat, coefficients, layout, twin,
                n_vertices, compute_dtype=None):
        proj = _project(_cast(features, compute_dtype),
                        _cast(w_flat, compute_dtype))
        ctx.save_for_backward(features, w_flat, coefficients,
                              proj if compute_dtype is None else None)
        ctx.layout, ctx.twin = layout, twin
        ctx.compute_dtype = compute_dtype
        return _combine(proj, coefficients, layout, n_vertices, twin=False)

    @staticmethod
    def backward(ctx, g):
        features, w_flat, coefficients, proj = ctx.saved_tensors
        cd = ctx.compute_dtype
        g = g.contiguous()
        d_features = None
        if ctx.needs_input_grad[0]:
            if ctx.twin is None:
                raise ValueError("basis_direction: the gradient with "
                                 "respect to features needs the "
                                 "direction's twin layout")
            w_t = basis_twin_weights(w_flat, coefficients.shape[1])
            d_features = _combine(_project(_cast(g, cd), _cast(w_t, cd)),
                                  coefficients, ctx.twin, features.shape[0],
                                  twin=True)
        d_w = d_c = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            if proj is None and ctx.needs_input_grad[2]:
                proj = _project(features, w_flat)
            d_w, d_c = basis_direction_dweights(
                features, proj, g, coefficients, ctx.layout,
                need_w=ctx.needs_input_grad[1],
                need_c=ctx.needs_input_grad[2])
        return d_features, d_w, d_c, None, None, None, None


def _project(x, w):
    """x @ w: the split pass and the basis_project kernel (f32), or the
    pad pass and basis_project_bf16 (bf16 x and w, a bf16 P), or the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return basis_project_reference(x, w)
    _check_project(x, w)
    lib = project_kernel_library()[0]
    if x.dtype == torch.bfloat16:
        out = launch_project_bf16(lib, x, w)
        basis_direction.bf16_pad_launches += 1
        basis_direction.bf16_project_launches += 1
        return out
    out = launch_project(lib, x, w)
    basis_direction.split_launches += 1
    basis_direction.project_launches += 1
    return out


def _combine(proj, coefficients, layout, n_rows, *, twin: bool):
    """One basis_combine pass (forward or twin), f32 or bf16 by ``proj``'s
    dtype, or its plain version for a CPU tensor."""
    if proj.device.type == "cpu":
        return basis_combine_reference(proj, coefficients, layout, n_rows)
    _check_combine(proj, coefficients, layout, n_rows)
    out = launch_combine(basis_kernel_library()[0], proj, coefficients,
                         layout, n_rows)
    bf16 = "bf16_" if proj.dtype == torch.bfloat16 else ""
    name = f"{bf16}twin_launches" if twin else f"{bf16}launches"
    setattr(basis_direction, name, getattr(basis_direction, name) + 1)
    if bf16:
        name = (f"bf16_{'twin_' if twin else ''}"
                f"{combine_route(proj, coefficients)}_launches")
        setattr(basis_direction, name, getattr(basis_direction, name) + 1)
    basis_direction.fixup_launches += 1
    return out


def combine_route(proj: torch.Tensor, coefficients: torch.Tensor) -> str:
    """The kernel ``launch_combine`` runs by default: the route of
    ``staircase.basis_combine_plan`` for P's shapes ("row" for f32,
    "chunk" for bf16)."""
    return staircase.basis_combine_plan(
        proj.shape[1] // coefficients.shape[1], proj.element_size()).route


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.basis_project_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def launch_split(lib: ctypes.CDLL, x: torch.Tensor,
                 w: torch.Tensor) -> tuple:
    """One launch of tf32_split_f32 on the current stream, on inputs
    already checked: (xs [parts, m, kp], ws [parts, n, kp]), the TF32
    parts of x and of w transposed (``tf32_split_reference``), K
    zero-padded to kp, a multiple of the kernel's k-tile; parts is 2, or 3
    for a short K (the kernel's ``basis_project_parts``). Raises if the
    launch is refused."""
    (m, k), n = x.shape, w.shape[1]
    tile = lib.basis_project_k_tile()
    kp = -(-k // tile) * tile
    parts = lib.basis_project_parts(k)
    xs = torch.empty(parts, m, kp, dtype=torch.float32, device=x.device)
    ws = torch.empty(parts, n, kp, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib, lib.tf32_split_f32(
        x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(), m, k, n,
        kp, parts, x.device.index, stream), "tf32_split")
    return xs, ws


def launch_product(lib: ctypes.CDLL, xs: torch.Tensor,
                   ws: torch.Tensor) -> torch.Tensor:
    """One launch of basis_project_f32 on the split parts (launch_split's
    output): P [m, n], the sum of the part products on the tensor cores.
    Raises if the launch is refused."""
    parts, m, kp = xs.shape
    n = ws.shape[1]
    out = torch.empty(m, n, dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    _raise_on(lib, lib.basis_project_f32(
        xs.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n, kp, parts,
        xs.device.index, stream), "basis_project")
    return out


def launch_project(lib: ctypes.CDLL, x: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x @ w on the current stream, on inputs already checked: the split
    pass, then basis_project_f32 (two launches); raises if one is
    refused."""
    return launch_product(lib, *launch_split(lib, x, w))


def launch_pad_bf16(lib: ctypes.CDLL, x: torch.Tensor,
                    w: torch.Tensor) -> tuple:
    """One launch of bf16_pad on the current stream, on bf16 inputs
    already checked: (xp [m, kp], wt [n, kp]), x and w transposed, K-major,
    K zero-padded to kp, a multiple of the kernel's
    ``basis_project_bf16_k_pad`` (``bf16_pad_reference``). Raises if the
    launch is refused."""
    (m, k), n = x.shape, w.shape[1]
    pad = lib.basis_project_bf16_k_pad()
    kp = -(-k // pad) * pad
    xp = torch.empty(m, kp, dtype=torch.bfloat16, device=x.device)
    wt = torch.empty(n, kp, dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib, lib.bf16_pad(
        x.data_ptr(), w.data_ptr(), xp.data_ptr(), wt.data_ptr(), m, k, n,
        kp, x.device.index, stream), "bf16_pad")
    return xp, wt


def launch_product_bf16(lib: ctypes.CDLL, xp: torch.Tensor,
                        wt: torch.Tensor) -> torch.Tensor:
    """One launch of basis_project_bf16 on the pad pass's output: P [m, n]
    bf16 = xp @ wt^T, f32 sums rounded to nearest even. Raises if the
    launch is refused."""
    (m, kp), n = xp.shape, wt.shape[0]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    _raise_on(lib, lib.basis_project_bf16(
        xp.data_ptr(), wt.data_ptr(), out.data_ptr(), m, kp, n,
        xp.device.index, stream), "basis_project_bf16")
    return out


def launch_project_bf16(lib: ctypes.CDLL, x: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """x @ w for bf16 x and w on the current stream, on inputs already
    checked: the pad pass, then basis_project_bf16 (two launches), P [m, n]
    bf16; raises if one is refused."""
    return launch_product_bf16(lib, *launch_pad_bf16(lib, x, w))


def launch_combine(lib: ctypes.CDLL, proj: torch.Tensor,
                   coefficients: torch.Tensor, layout: CsrLayout,
                   n_rows: int, *, items: Optional[int] = None,
                   carries: bool = False, route: Optional[str] = None):
    """One call of basis_combine_f32, or for a bf16 ``proj`` of
    basis_combine_bf16 (the chunk kernel) or basis_combine_row_bf16 (PR 6's
    kernel), each a merge-path kernel and then its carry fix-up, on the
    current stream, on inputs already checked; raises if a launch is
    refused. ``route`` ("chunk" or "row") defaults to ``combine_route``,
    which the main path takes: it is for timing one bf16 kernel against
    the other, and "chunk" raises for f32. Returns ``out``, or (out,
    carry_rows) with ``carries`` (see ``staircase.merge_path_carry_rows``).
    ``items`` defaults to ``staircase.basis_combine_items``."""
    n_bases = coefficients.shape[1]
    d_out = proj.shape[1] // n_bases
    bf16 = proj.dtype == torch.bfloat16
    plan = staircase.basis_combine_plan(d_out, proj.element_size())
    route = route or combine_route(proj, coefficients)
    if route not in ("chunk", "row") or (route == "chunk" and not bf16):
        raise ValueError(f"basis_combine: no {route!r} route for "
                         f"{proj.dtype} P")
    if route == "chunk" and proj.data_ptr() % (2 * plan.cols):
        raise ValueError(f"basis_combine: the chunk route reads P in "
                         f"{2 * plan.cols}-byte words; it does not start "
                         f"on one")
    if items is None:
        items = staircase.basis_combine_items(n_rows, layout.n_edges)
    carry_rows, carry = _carry_buffers(
        n_rows, layout.n_edges, items, d_out, lib.basis_combine_max_items(),
        proj.device)
    out = torch.empty(n_rows, d_out, dtype=torch.float32,
                      device=proj.device)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    args = (proj.data_ptr(), coefficients.data_ptr(),
            layout.row_ptr.data_ptr(), layout.src.data_ptr(),
            layout.rel.data_ptr(), layout.w.data_ptr(), out.data_ptr(),
            carry_rows.data_ptr(), carry.data_ptr(), n_rows, layout.n_edges,
            n_bases, d_out, items)
    if route == "chunk":
        rc = lib.basis_combine_bf16(*args, plan.cols, plan.chunk_cols,
                                    proj.device.index, stream)
    else:
        fn = lib.basis_combine_row_bf16 if bf16 else lib.basis_combine_f32
        rc = fn(*args, proj.device.index, stream)
    if rc != 0:
        msg = lib.basis_direction_error_string(rc).decode()
        raise RuntimeError(f"basis_combine kernel launch failed: {msg} "
                           f"({rc})")
    return (out, carry_rows) if carries else out


def _check_project(x, w) -> None:
    """Raise on anything basis_project_f32 or basis_project_bf16 does not
    take."""
    dtype = input_dtype("basis_project", x, w)
    check_tensors("basis_project", x.device, {"x": x, "w": w},
                   {"x": dtype, "w": dtype})
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"basis_project: cannot multiply "
                         f"{tuple(x.shape)} by {tuple(w.shape)}")
    if max(x.shape[0], x.shape[1], w.shape[1]) >= 2 ** 31:
        raise ValueError("basis_project: a dimension overflows int32")


def _check_combine(proj, coefficients, layout, n_rows) -> None:
    """Raise on anything basis_combine_f32 does not take."""
    tensors, dtypes = _csr_tensors(layout)
    check_tensors("basis_combine", proj.device,
                   {"proj": proj, "coefficients": coefficients, **tensors},
                   {"proj": input_dtype("basis_combine", proj),
                    "coefficients": torch.float32, **dtypes})
    lib, _ = basis_kernel_library()
    if coefficients.dim() != 2 or proj.dim() != 2:
        raise ValueError("basis_combine: proj and coefficients must be 2-d")
    n_bases = coefficients.shape[1]
    if not 1 <= n_bases <= lib.basis_direction_max_bases() \
            or proj.shape[1] % n_bases:
        raise ValueError(f"basis_combine: kernel takes B in [1, "
                         f"{lib.basis_direction_max_bases()}] dividing "
                         f"proj's {proj.shape[1]} columns, got B={n_bases}")
    if proj.shape[1] < 1:
        raise ValueError("basis_combine: proj has no columns")
    if layout.n_rows != n_rows:
        raise ValueError(f"basis_combine: layout has {layout.n_rows} rows, "
                         f"expected {n_rows}")
    if proj.shape[0] != layout.source_rows:
        raise ValueError(f"basis_combine: proj has {proj.shape[0]} rows, "
                         f"the layout gathers from {layout.source_rows}")
    e = layout.n_edges
    if layout.rel.shape[0] != e or layout.w.shape[0] != e:
        raise ValueError("basis_combine: src, rel and w differ in length")


# ---------------------------------------------------------------------------
# scatter2 (TPU kernel 4), on the kernel of ops/staircase.py
# ---------------------------------------------------------------------------

def scatter2(msgs: torch.Tensor, layout: CsrLayout, n_vertices: int,
             order, compute_dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """out[v] = sum over edges e with target v of w_e * msgs[e], with
    ``msgs`` [E_in, d] in primary (input) edge order: ``layout`` and
    ``order`` are what ``graph.build_csr`` returned for those edges (CSR
    entry k is input edge ``order[k]``; padding edges, dropped there, add
    nothing). The permutation is fused into the kernel's gather.
    ``compute_dtype`` torch.bfloat16 sends the messages to the kernel in
    bf16 (JAX's ``compute_dtype``). Differentiable: d msgs[order[k]] = w_k *
    g[row(k)], zero for padding edges. Returns [n_vertices, d] float32.

    Raises ValueError unless every ``order`` entry lies in [0, E_in), on
    the CPU path and the card's alike; host data is checked before it is
    copied to the card (a CUDA ``order`` costs one reduction and a sync)."""
    order = torch.as_tensor(order)
    n = msgs.shape[0]
    if order.numel():
        lo, hi = torch.stack(torch.aminmax(order)).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(f"scatter2: order holds {lo}..{hi}, outside "
                             f"[0, {n}) of msgs")
    perm = order.to(device=msgs.device, dtype=torch.int32)
    return staircase._Aggregate.apply(msgs, layout, n_vertices, perm, True,
                                      scatter2, compute_dtype)


def scatter2_slot_order(msgs_csr: torch.Tensor, layout: CsrLayout,
                        n_vertices: int) -> torch.Tensor:
    """The scatter of messages already in the layout's entry order with
    their weights applied: out[v] = sum over CSR entries k of row v of
    msgs_csr[k]. Differentiable: d msgs_csr[k] = g[row(k)]."""
    return staircase._Aggregate.apply(msgs_csr, layout, n_vertices, None,
                                      False, scatter2_slot_order)


# Kernel launches since the counts were last set to 0, f32 and bf16 apart
# (CPU calls never count).
scatter2.launches = 0
scatter2.bf16_launches = 0
scatter2_slot_order.launches = 0
scatter2_slot_order.bf16_launches = 0
