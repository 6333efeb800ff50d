"""Weighted segment sum of per-edge messages over one direction's CSR: the
CUDA kernel and its plain form.

Counterpart of ``relationprediction_tpu/ops/staircase.py`` (same module
name). ``staircase_aggregate`` computes

    out[v] = sum over CSR entries k of row v of w_k * msgs[k]

with ``msgs`` [E, d] in the layout's own entry order (the model path builds
each direction's messages from that direction's ``src`` and ``rel``), and
its gradient (the JAX package's VJP, a row gather, ``staircase.py:276-284``)

    d msgs[k] = w_k * g[row(k)]

as torch ops. The JAX op takes messages in primary edge order and fuses the
permutation into its gather; here the same sum with a permutation is
``staircase2.scatter2`` (the port's TPU kernel 4), which passes the CSR's
``order`` as ``perm`` to the same kernel.

On a CUDA tensor the forward launches ``staircase_aggregate_f32`` of
``csrc/staircase.cu`` or raises; on a CPU tensor it runs
``staircase_aggregate_reference``, the plain PyTorch version. With
``compute_dtype=torch.bfloat16`` (the JAX op's ``compute_dtype``,
``staircase.py:263-266``: bf16 message precision) the messages go to the
kernel in bf16 and ``staircase_aggregate_bf16`` runs: the weights, the
products and the sums stay f32, and the output and the gradient are f32.
The JAX op rounds each weighted message to bf16, the port each message
before its f32 weight; the plain version upcasts the bf16 messages and
sums as in f32. A bf16 CUDA tensor launches the bf16 kernel or raises:
it never reaches the f32 kernel. The kernel
splits the merged list of row ends and entries into blocks of
``merge_path_items`` items (a merge path, see the source);
``merge_path_split`` and ``merge_path_carry_rows`` state that partition in
Python for the tests and ``chip_smoke.py``, and nothing on the main path
calls them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..graph import CsrLayout
from . import nvcc

_SOURCE = "staircase.cu"
_EDGE_CHUNK = 16384
# Items (row ends + entries) a thread block of a merge-path kernel takes:
# the most, up to its largest, that still make _MIN_BLOCKS blocks, and at
# least its smallest; chosen for each kernel by the sweeps of its phase in
# chip_smoke.py (PERF.md).
_MIN_BLOCKS = 512
# basis_combine_bf16's chunk kernel (csrc/basis_direction.cu): the threads
# of a thread block's group, which lie across the words of one column
# chunk (its kGroupThreads), and the bf16 columns a thread loads as one
# 8-byte word where d_out allows it (kWordCols).
COMBINE_CHUNK_THREADS = 128
COMBINE_WORD_COLS = 4


@functools.lru_cache(maxsize=None)
def kernel_library() -> tuple:
    """Build (at first use) and bind the kernel: (CDLL, nvcc.BuildInfo)."""
    lib, info = nvcc.load(_SOURCE)
    return bind_library(lib), info


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from the kernel source."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.staircase_aggregate_f32, lib.staircase_aggregate_bf16):
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    lib.staircase_max_items.argtypes = []
    lib.staircase_max_items.restype = i
    lib.staircase_error_string.argtypes = [i]
    lib.staircase_error_string.restype = ctypes.c_char_p
    return lib


def row_of_entry(layout: CsrLayout) -> torch.Tensor:
    """The row (target) of every CSR entry. The entry count comes from the
    layout's shape, so a CUDA layout is expanded without reading its
    row_ptr on the host (no sync; a CUDA graph can capture it)."""
    return torch.repeat_interleave(
        torch.arange(layout.n_rows, device=layout.row_ptr.device),
        layout.row_ptr.diff().long(), output_size=layout.n_edges)


def merge_path_blocks(n_rows: int, n_edges: int, items: int) -> int:
    """Thread blocks of one launch, ceil((n_rows + E) / items); raises
    where the merged list's length overflows the kernels' int32."""
    if items < 1:
        raise ValueError(f"merge path: items must be >= 1, got {items}")
    if n_rows + n_edges >= 2 ** 31:
        raise ValueError(f"merge path: n_rows + E = {n_rows + n_edges} "
                         f"overflows int32")
    return -(-(n_rows + n_edges) // items)


def merge_path_items(n_rows: int, n_edges: int, least: int = 32,
                     most: int = 512) -> int:
    """Items a block takes for a list of n_rows row ends and n_edges
    entries: the most, halving from ``most``, that still give 512 blocks,
    and at least ``least``. By default staircase_aggregate's rule: 512 on
    the full FB15k-237 graph (287k items), 32 at the train shape
    (29.5k)."""
    items = most
    while items > least and n_rows + n_edges < _MIN_BLOCKS * items:
        items //= 2
    return items


def block_direction_items(n_rows: int, n_edges: int) -> int:
    """Items a block of block_direction_f32 takes (forward and twin pass):
    64 on the full FB15k-237 graph, 32 at the train shape. Larger blocks
    lose: the kernel is bound by its W reloads from L2, and fewer blocks
    hide less of their latency."""
    return merge_path_items(n_rows, n_edges, least=32, most=64)


def basis_combine_items(n_rows: int, n_edges: int) -> int:
    """Items a block of basis_combine_f32 takes (an entry gathers B P
    rows, 5x kernel 3's bytes at B = 5): 128 on the full FB15k-237 graph,
    32 at the train shape."""
    return merge_path_items(n_rows, n_edges, least=16, most=128)


@dataclasses.dataclass(frozen=True)
class CombinePlan:
    """How basis_combine runs for P's parts of d_out columns: ``route``
    "chunk" (bf16 P: the columns cut into ``n_chunks`` chunks of
    ``chunk_cols``, the last one shorter, each thread ``cols`` columns) or
    "row" (f32 P: PR 6's kernel, the columns of whole rows across a thread
    block; the other fields 0)."""

    route: str
    cols: int = 0
    chunk_cols: int = 0
    n_chunks: int = 0

    def chunks(self, d_out: int) -> list:
        """(first, end) columns of each chunk."""
        c = self.chunk_cols
        return [(k * c, min((k + 1) * c, d_out))
                for k in range(self.n_chunks)]


@functools.lru_cache(maxsize=None)
def basis_combine_plan(d_out: int, elem: int = 2) -> CombinePlan:
    """basis_combine's route for these shapes, from the shapes alone (the
    columns of P's parts and its element bytes): "row" for f32, else
    "chunk" with 4 columns a thread where d_out % 4 == 0, else 1, and as
    few chunks of at most COMBINE_CHUNK_THREADS words as cover the
    columns, evened out. gcn_basis.exp (d_out = 500): one chunk of 500
    columns. (Chunks sized to keep a slice of P in L2 were measured
    slower; PERF.md.)"""
    if elem != 2:
        return CombinePlan("row")
    cols = COMBINE_WORD_COLS if d_out % COMBINE_WORD_COLS == 0 else 1
    words = d_out // cols
    chunk_words = -(-words // -(-words // COMBINE_CHUNK_THREADS))
    return CombinePlan("chunk", cols, chunk_words * cols,
                       -(-words // chunk_words))


def merge_path_split(row_ptr: torch.Tensor, items: int) -> tuple:
    """Where each block of the kernel's partition starts: (rows, entries),
    each int64 [n_blocks + 1], the merge-path coordinate at item
    b * items (the last at the list's end). Row end v is item
    row_ptr[v + 1] + v of the merged list, so the rows ended before item k
    are those with row_ptr[v + 1] + v < k."""
    n_rows = row_ptr.shape[0] - 1
    n_edges = int(row_ptr[-1])
    total = n_rows + n_edges
    n_blocks = merge_path_blocks(n_rows, n_edges, items)
    diag = torch.clamp(torch.arange(n_blocks + 1, dtype=torch.int64) * items,
                       max=total)
    keys = row_ptr[1:].long().cpu() + torch.arange(n_rows)
    rows = torch.searchsorted(keys, diag, side="left")
    return rows, diag - rows


def merge_path_carry_rows(row_ptr: torch.Tensor, items: int) -> torch.Tensor:
    """int32 [n_blocks]: the row in progress at the end of each block (it
    began there or earlier and ends in a later block), -1 where none; what
    the kernel leaves in its carry_row buffer."""
    rows, entries = merge_path_split(row_ptr, items)
    end_rows, end_entries = rows[1:], entries[1:]
    starts = row_ptr.long().cpu()[torch.clamp(end_rows, max=len(row_ptr) - 1)]
    carried = (end_rows < len(row_ptr) - 1) & (end_entries > starts)
    return torch.where(carried, end_rows, -1).to(torch.int32)


def staircase_aggregate_reference(msgs: torch.Tensor, layout: CsrLayout,
                                  n_vertices: int,
                                  perm: Optional[torch.Tensor] = None,
                                  weighted: bool = True,
                                  edge_chunk: int = _EDGE_CHUNK
                                  ) -> torch.Tensor:
    """Plain version: per chunk of entries, gather the messages (row
    ``perm[k]`` where given, else row k), weight them by ``w`` (unless
    ``weighted`` is false) and ``index_add_`` them into their rows. Sums in
    the messages' dtype (float64 inputs give a float64 result; bf16
    messages are upcast and summed in float32)."""
    msgs = upcast_bf16(msgs)
    rows = row_of_entry(layout)
    out = torch.zeros(n_vertices, msgs.shape[1], dtype=msgs.dtype,
                      device=msgs.device)
    for start in range(0, layout.n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        m = msgs[perm[sl].long()] if perm is not None else msgs[sl]
        if weighted:
            m = m * layout.w[sl, None].to(msgs.dtype)
        out.index_add_(0, rows[sl], m)
    return out


def upcast_bf16(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as float32 (exact), any other as it is: the plain
    versions of the bf16 kernels compute in float32."""
    return t.float() if t.dtype == torch.bfloat16 else t


def staircase_aggregate(msgs: torch.Tensor, layout: CsrLayout,
                        n_vertices: int, *, weighted: bool = True,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """One direction's aggregation, differentiable; see the module
    docstring.

    msgs: [E, d] float32, entry k the message of the layout's entry k;
    layout: the direction's CSR with n_vertices rows. ``weighted`` false
    takes every weight as 1 (the stored-message layer's 'none'
    normalization). ``compute_dtype`` torch.bfloat16 sends the messages
    to the kernel in bf16. Returns [n_vertices, d] float32.
    """
    if msgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"staircase_aggregate: unsupported device "
                         f"{msgs.device}")
    return _Aggregate.apply(msgs, layout, n_vertices, None, weighted,
                            staircase_aggregate, compute_dtype)


# Kernel launches since the counts were last set to 0 (CPU calls never
# count): the merge-path kernel of this op, f32 and bf16 apart, and the
# carry fix-up kernel that follows every merge-path launch of this op,
# scatter2, scatter2_slot_order and the bf16 factored energies' backward
# (ops/neg_energy.py).
staircase_aggregate.launches = 0
staircase_aggregate.bf16_launches = 0
staircase_aggregate.fixup_launches = 0


class _Aggregate(torch.autograd.Function):
    """Forward: the kernel (``perm`` may be None; ``weighted`` false takes
    every weight as 1) on the messages cast to ``compute_dtype`` where it
    is given, counted on ``counter``. Backward: the row gather
    d msgs[perm[k] or k] = w_k * g[row(k)] in the cotangent's float32;
    messages no entry reads (the padding edges of scatter2) get zero."""

    @staticmethod
    def forward(ctx, msgs, layout, n_vertices, perm, weighted, counter,
                compute_dtype=None):
        ctx.layout, ctx.perm, ctx.weighted = layout, perm, weighted
        ctx.n_msgs = msgs.shape[0]
        if compute_dtype is not None:
            msgs = msgs.to(compute_dtype)
        return aggregate(msgs, layout, n_vertices, perm, weighted=weighted,
                         counter=counter)

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        d_entries = g[row_of_entry(layout)]
        if ctx.weighted:
            d_entries = d_entries * layout.w[:, None]
        if ctx.perm is None:
            return d_entries, None, None, None, None, None, None
        d_msgs = g.new_zeros(ctx.n_msgs, g.shape[1])
        d_msgs.index_copy_(0, ctx.perm.long(), d_entries)
        return d_msgs, None, None, None, None, None, None


def aggregate(msgs: torch.Tensor, layout: CsrLayout, n_vertices: int,
              perm: Optional[torch.Tensor] = None, *, weighted: bool = True,
              counter=None) -> torch.Tensor:
    """One kernel call (the merge-path kernel and its carry fix-up), f32 or
    bf16 by the messages' dtype, which adds one to ``counter.launches``
    (``counter.bf16_launches`` for bf16) where a counter is given and to
    ``staircase_aggregate.fixup_launches``, or the plain version for a CPU
    tensor."""
    if msgs.device.type == "cpu":
        return staircase_aggregate_reference(msgs, layout, n_vertices, perm,
                                             weighted)
    _check(msgs, layout, n_vertices, perm)
    out = launch(kernel_library()[0], msgs, layout, n_vertices, perm,
                 weighted=weighted)
    if counter is not None:
        if msgs.dtype == torch.bfloat16:
            counter.bf16_launches += 1
        else:
            counter.launches += 1
    staircase_aggregate.fixup_launches += 1
    return out


def launch(lib: ctypes.CDLL, msgs: torch.Tensor, layout: CsrLayout,
           n_vertices: int, perm: Optional[torch.Tensor] = None, *,
           weighted: bool = True, items: Optional[int] = None,
           carries: bool = False):
    """One call of staircase_aggregate_f32, or of staircase_aggregate_bf16
    for bf16 ``msgs`` (the merge-path kernel, then its carry fix-up), on
    the current stream, on inputs already checked; raises if a launch is
    refused. ``weighted`` false passes no weights (each
    entry's weight is 1). Returns ``out``, or (out, carry_rows) with
    ``carries``: the kernel's carried row of each block (see
    ``merge_path_carry_rows``). ``items`` defaults to
    ``merge_path_items``."""
    if items is None:
        items = merge_path_items(n_vertices, layout.n_edges)
    n_blocks = merge_path_blocks(n_vertices, layout.n_edges, items)
    if items > lib.staircase_max_items():
        raise ValueError(f"staircase_aggregate: kernel takes items <= "
                         f"{lib.staircase_max_items()}, got {items}")
    d = msgs.shape[1]
    out = torch.empty(n_vertices, d, dtype=torch.float32, device=msgs.device)
    carry_rows = torch.empty(n_blocks, dtype=torch.int32, device=msgs.device)
    carry = torch.empty(n_blocks, d, dtype=torch.float32, device=msgs.device)
    stream = torch.cuda.current_stream(msgs.device).cuda_stream
    fn = lib.staircase_aggregate_bf16 if msgs.dtype == torch.bfloat16 \
        else lib.staircase_aggregate_f32
    rc = fn(
        msgs.data_ptr(), None if perm is None else perm.data_ptr(),
        layout.row_ptr.data_ptr(), layout.w.data_ptr() if weighted else None,
        out.data_ptr(), carry_rows.data_ptr(), carry.data_ptr(), n_vertices,
        layout.n_edges, d, msgs.shape[0], items, msgs.device.index, stream)
    if rc != 0:
        msg = lib.staircase_error_string(rc).decode()
        raise RuntimeError(f"staircase_aggregate kernel launch failed: {msg} "
                           f"({rc})")
    return (out, carry_rows) if carries else out


def input_dtype(op: str, *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of a kernel's gathered inputs: float32 (its f32 entry
    point) or bfloat16 (its bf16 one). Raises TypeError for any other, or
    where they differ."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"{op}: inputs must all be float32 or all bfloat16, "
                        f"got {sorted(str(d) for d in dtypes)}")
    return dtypes.pop()


def check_tensors(op: str, device, tensors: dict, dtypes: dict) -> None:
    """Raise unless every tensor is on ``device``, of its dtype and
    contiguous."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{op}: {name} is {t.dtype}, expected "
                            f"{dtypes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")


def _check(msgs, layout, n_vertices, perm) -> None:
    """Raise on anything the kernel does not take."""
    tensors = {"msgs": msgs, "row_ptr": layout.row_ptr, "w": layout.w}
    dtypes = {"msgs": input_dtype("staircase_aggregate", msgs),
              "row_ptr": torch.int32, "w": torch.float32}
    if perm is not None:
        tensors["perm"], dtypes["perm"] = perm, torch.int32
    check_tensors("staircase_aggregate", msgs.device, tensors, dtypes)
    if msgs.dim() != 2 or msgs.shape[1] < 1:
        raise ValueError(f"staircase_aggregate: msgs must be [n, d] with "
                         f"d >= 1, got {tuple(msgs.shape)}")
    if max(msgs.shape[0], msgs.shape[1], n_vertices) >= 2 ** 31:
        raise ValueError("staircase_aggregate: a dimension overflows int32")
    if layout.n_rows != n_vertices:
        raise ValueError(f"staircase_aggregate: layout has {layout.n_rows} "
                         f"rows, expected {n_vertices}")
    e = layout.n_edges
    if layout.w.shape[0] != e:
        raise ValueError("staircase_aggregate: src and w differ in length")
    if perm is None and msgs.shape[0] != e:
        raise ValueError(f"staircase_aggregate: {msgs.shape[0]} messages "
                         f"for {e} entries")
    if perm is not None and perm.shape != (e,):
        raise ValueError(f"staircase_aggregate: perm {tuple(perm.shape)} "
                         f"for {e} entries")
