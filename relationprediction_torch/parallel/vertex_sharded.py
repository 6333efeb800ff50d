"""Vertex-sharded training and evaluation over ``torch.distributed``
(``relationprediction_tpu/parallel/vertex_sharded.py``): the path for
entity tables and activations beyond one card's memory.

Where the edge mesh (``parallel/mesh.py``) replicates the [V, d]
activations and all-reduces partial sums, this path shards the vertex
axis over the ranks of an ``EdgeMesh``:

* rank s owns the rows [s * rows_per, (s + 1) * rows_per) of the entity
  table (the input transform's W, padded to v_pad = n * rows_per rows) and
  of every layer's activations; every other parameter is replicated;
* the message edges are partitioned by their target's shard
  (``partition_edges_by_destination``), weighted 1 / degree over the
  whole graph, so that each rank sums exactly its owned rows;
* each layer fetches the source rows its edges read with one all-to-all
  (the targeted halo exchange: ``build_halo``'s host lists,
  ``collectives.halo_exchange``), or with an all-gather of every row
  (``halo='all_gather'``);
* the loss fetches its batch's entity codes through a second halo, so the
  gradients flow home into the sharded table through the all-to-all's
  backward.

The kernels run on shard-local rectangular CSR layouts (``shard_graph``):
a direction's layout sums into the rank's ``rows_per`` owned rows from a
halo buffer of n * h + rows_per rows (v_pad with the all-gather), and its
twin is the reverse, so the fused routes (gcn_block's ``block_direction``,
gcn_basis's ``basis_direction``) launch the card's kernels 1 and 2 and
their twin passes, and the unfused routes (gcn_diag, basis_plus_diag,
basis_times_diag, and every variant under ``overlap``) sum their per-edge
messages with kernel 3 (``staircase_aggregate``). Each rank builds only
its own shard's CSRs; the host arrays (``prepare``, ``prepare_batch``,
``prepare_batch_factored``, the pipeline's batches) equal the JAX
package's bit for bit.

The gradients (``reduce_grads``): every rank's backward starts from its
copy of the global loss, whose all-reduces give N times its share, so the
replicated leaves take the mean over the ranks, as on the edge mesh, and
the entity table's rows, whose cotangents arrived from every rank through
the all-to-all's backward, are only divided by N. A mean of the table
over the ranks would average different vertices' rows. The global-norm
clip counts each replicated leaf once and the table's all-reduced sum of
squares (``sum_of_squares``); Adam's moments of the table stay on their
rank.

Train-mode dropout: ``dropout_mode='per_shard'`` draws each rank's
[rows_per, d] keep-mask from its own (seed, step, rank) generator (the
same distribution as one device, another stream); ``'full_parity'`` draws
the one-device [V, d] mask and keeps the rank's rows, for the tests and
the card's comparison with the one-device step.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..graph import CsrLayout, build_csr
from ..models import decoders as decoders_lib
from ..models import encoders as enc
from ..models.build import RGCNModel, binomial_factored_objective
from ..ops import staircase, staircase2
from ..ops.gather import take_rows
from ..ops.neg_energy import factored_negative_energies
from ..params import map_tree, tree_leaves, tree_unflatten
from ..sampling import AdjacencyIndex, NegativeSampler, draw_subgraph
from .collectives import (all_gather_rows, all_reduce_sum, halo_exchange,
                          halo_exchange_remote, pmean)
from .mesh import EdgeMesh, replicate


# The pipeline's budget probe: samples drawn, and the margin over their
# largest counts.
PROBES = 8
SLACK = 1.5


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def partition_edges_by_destination(triples: np.ndarray, n_vertices: int,
                                   n_shards: int, pad_to: int,
                                   n_relations: int):
    """Shard s owns vertices [s * rows_per, (s + 1) * rows_per), rows_per =
    ceil(V / n), and gets the edges whose receiver (forward) / sender
    (backward) it owns, stable-sorted by that target (``:67-119``).
    Returns (forward arrays, backward arrays, rows_per), each arrays a
    (senders, relations, receivers, mask, norm) tuple of [n, pad_to]
    arrays; padding slots hold V as both endpoints and weight 0. Weights
    are 1 / degree over the whole graph, so each shard's sum is exact."""
    triples = np.asarray(triples, dtype=np.int32)
    rows_per = -(-n_vertices // n_shards)

    fwd_shard = triples[:, 2] // rows_per
    bwd_shard = triples[:, 0] // rows_per

    def pack(shard_ids, order_col):
        out = []
        for s in range(n_shards):
            mine = triples[shard_ids == s]
            mine = mine[np.argsort(mine[:, order_col], kind="stable")]
            if len(mine) > pad_to:
                raise ValueError(f"shard {s} has {len(mine)} edges > "
                                 f"pad_to {pad_to}")
            out.append(mine)
        return out

    fwd_parts = pack(fwd_shard, 2)
    bwd_parts = pack(bwd_shard, 0)
    deg_in = np.bincount(triples[:, 2], minlength=n_vertices + 1)
    deg_out = np.bincount(triples[:, 0], minlength=n_vertices + 1)

    def arrays(parts, deg, target_col):
        sen = np.full((n_shards, pad_to), n_vertices, np.int32)
        rel = np.zeros((n_shards, pad_to), np.int32)
        rec = np.full((n_shards, pad_to), n_vertices, np.int32)
        msk = np.zeros((n_shards, pad_to), np.float32)
        nrm = np.zeros((n_shards, pad_to), np.float32)
        for s, mine in enumerate(parts):
            m = len(mine)
            sen[s, :m] = mine[:, 0]
            rel[s, :m] = mine[:, 1]
            rec[s, :m] = mine[:, 2]
            msk[s, :m] = 1.0
            nrm[s, :m] = 1.0 / np.maximum(deg[mine[:, target_col]], 1)
        return sen, rel, rec, msk, nrm

    return (arrays(fwd_parts, deg_in, 2), arrays(bwd_parts, deg_out, 0),
            rows_per)


class HaloLayout(NamedTuple):
    """A targeted boundary exchange (``:122-138``). send_idx [n_src,
    n_dst, h] int32: the local row (in the source rank's shard) that rank
    src ships to rank dst, 0 in a pad slot (nothing points at it); h: the
    row budget of every (owner, consumer) pair, a multiple of 8."""

    send_idx: np.ndarray
    h: int


def build_halo(sources_per_shard, mask_per_shard, rows_per: int,
               n_shards: int, n_vertices: int,
               h_budget: Optional[int] = None):
    """(HaloLayout, ptr [n, K] int32) for consumer shards that read the
    global vertex ids ``sources_per_shard`` [n, K] where
    ``mask_per_shard`` > 0 (``:141-212``). ptr indexes the consumer's
    buffer of n * h exchanged rows (block q from owner q, in ascending
    local row order) followed by its own rows_per rows: an own-shard read
    points into that local slab and never rides the exchange. A padding
    entry points at 0. ``h_budget``: a fixed h for every batch; a
    boundary that needs more raises ValueError."""
    sources = np.asarray(sources_per_shard, dtype=np.int64)
    masks = np.asarray(mask_per_shard)
    assert sources.shape[0] == n_shards

    rows: list = [[None] * n_shards for _ in range(n_shards)]
    h = 8
    for d in range(n_shards):
        live = sources[d][masks[d] > 0]
        live = live[live < n_vertices]  # drop phantom sentinels
        owners = live // rows_per
        for q in range(n_shards):
            if q == d:
                continue
            r = np.unique(live[owners == q] % rows_per).astype(np.int64)
            rows[d][q] = r
            h = max(h, _round_up(len(r), 8))
    if h_budget is not None:
        if h > h_budget:
            raise ValueError(
                f"halo budget {h_budget} rows < required {h}; raise the "
                "budget (probe_budgets slack) or resample the subgraph")
        h = h_budget

    send_idx = np.zeros((n_shards, n_shards, h), np.int32)
    for d in range(n_shards):
        for q in range(n_shards):
            if q != d:
                send_idx[q, d, :len(rows[d][q])] = rows[d][q]

    ptr = np.zeros(sources.shape, np.int32)
    for d in range(n_shards):
        src = sources[d]
        valid = (masks[d] > 0) & (src < n_vertices)
        owners = np.where(valid, src // rows_per, 0)
        local = np.where(valid, src % rows_per, 0)
        p = np.zeros(src.shape, np.int64)
        for q in range(n_shards):
            sel = valid & (owners == q)
            if not sel.any():
                continue
            if q == d:
                p[sel] = n_shards * h + local[sel]
            else:
                p[sel] = q * h + np.searchsorted(rows[d][q], local[sel])
        ptr[d] = p.astype(np.int32)
    return HaloLayout(send_idx, h), ptr


def halo_traffic_rows(layout: HaloLayout, rows_per: int, n_shards: int):
    """Rows each shard ships to the others an exchange: (targeted,
    all_gather) (``:215-218``)."""
    return (n_shards - 1) * layout.h, (n_shards - 1) * rows_per


# ---------------------------------------------------------------------------
# A rank's layouts and batch, as tensors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardDirection:
    """One direction's layouts on one rank: ``csr`` sums into the rank's
    rows_per owned rows from its source table (the halo buffer of
    ``n_remote`` + rows_per rows, or the all-gathered v_pad rows; entry k
    reads row src[k]); ``twin``, for the fused routes' backward, is the
    reverse (the table's rows from the owned rows, the same weights);
    ``send_idx`` [n, h] int64, the targeted exchange's rows this rank
    ships to each rank (None with the all-gather)."""

    csr: CsrLayout
    twin: Optional[CsrLayout]
    send_idx: Optional[torch.Tensor]
    n_remote: int

    def map(self, fn) -> "ShardDirection":
        return ShardDirection(
            self.csr.map(fn), None if self.twin is None else self.twin.map(fn),
            None if self.send_idx is None else fn(self.send_idx),
            self.n_remote)

    def tensors(self) -> list:
        out = self.csr.tensors()
        if self.twin is not None:
            out += self.twin.tensors()
        return out + ([] if self.send_idx is None else [self.send_idx])


class ShardGraph(NamedTuple):
    """A rank's message graph: its forward (by receiver, reading senders)
    and backward (by sender, reading receivers) directions."""

    fwd: ShardDirection
    bwd: ShardDirection

    def to(self, device, non_blocking: bool = False) -> "ShardGraph":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "ShardGraph":
        return self._map(lambda t: t.pin_memory())

    def _map(self, fn) -> "ShardGraph":
        return ShardGraph(self.fwd.map(fn), self.bwd.map(fn))

    def tensors(self) -> list:
        return self.fwd.tensors() + self.bwd.tensors()


class ShardLoss(NamedTuple):
    """A rank's slice of a loss batch (``prepare_batch`` or
    ``prepare_batch_factored``): triples [T, 3] int64, labels [T] f32
    (None in factored mode), mask [T] f32, the decoder halo's send rows
    [n, h] int64 and the pointers of e1, e2 [T] (and of the corrupted
    entities, ev [T, k]) into its buffer; the factored mode's values
    [T, k] and corrupt_object [T, k] bool."""

    triples: torch.Tensor
    labels: Optional[torch.Tensor]
    mask: torch.Tensor
    dec_send: torch.Tensor
    e1_ptr: torch.Tensor
    e2_ptr: torch.Tensor
    neg_values: Optional[torch.Tensor] = None
    corrupt_object: Optional[torch.Tensor] = None
    ev_ptr: Optional[torch.Tensor] = None

    @property
    def factored(self) -> bool:
        return self.ev_ptr is not None

    def _map(self, fn) -> "ShardLoss":
        return ShardLoss(*(None if t is None else fn(t) for t in self))

    def tensors(self) -> list:
        return [t for t in self if t is not None]


class VSRankBatch(NamedTuple):
    """A rank's training batch: its graph and its loss slice, with the
    ``TrainBatch`` surface that the prefetcher moves (``to``,
    ``pin_memory``, ``tensors``)."""

    graph: ShardGraph
    loss: ShardLoss

    def to(self, device, non_blocking: bool = False) -> "VSRankBatch":
        return VSRankBatch(self.graph.to(device, non_blocking),
                           self.loss._map(lambda t: t.to(
                               device, non_blocking=non_blocking)))

    def pin_memory(self) -> "VSRankBatch":
        return VSRankBatch(self.graph.pin_memory(),
                           self.loss._map(lambda t: t.pin_memory()))

    def tensors(self) -> list:
        return self.graph.tensors() + self.loss.tensors()


def _long(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


def _is_table(path: tuple) -> bool:
    """The entity table's leaf (and its optimizer moments'):
    ``input_transform/W`` at the end of its path."""
    return path[-2:] == ("input_transform", "W")


def _leaf_paths(tree, prefix=()) -> list:
    """The paths of ``tree``'s leaves, in ``tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, prefix + (i,))]
    return [prefix]


def table_mask(tree) -> List[bool]:
    """For each leaf of ``tree`` in ``tree_leaves`` order: whether it is
    the row-sharded entity table (or an optimizer moment of it)."""
    return [_is_table(p) for p in _leaf_paths(tree)]


SUPPORTED_VARIANTS = ("basis", "block", "diag", "basis_plus_diag",
                      "basis_times_diag")


class VertexShardedEncoder:
    """The vertex-sharded encode, losses and step of ``model`` on ``mesh``
    (``:244-945``): this rank's part of each, called by every rank.

    halo: 'targeted' (the default: per-pair boundary lists, one all-to-all
    a layer and direction) or 'all_gather' (every row). overlap: the
    targeted schedule that issues both directions' exchanges, computes the
    local-source messages and the self-loop while the rows travel, then
    the remote-source ones (``:568-596``), on the unfused route; like
    JAX's, it computes every edge's message twice, masked, about twice the
    message work of the sequential unfused route. dropout_mode:
    'per_shard' or 'full_parity' (module docstring). Block and basis
    without overlap take the fused kernels on the rectangular layouts
    (``fused``)."""

    def __init__(self, model: RGCNModel, mesh: EdgeMesh,
                 halo: str = "targeted", overlap: bool = False,
                 dropout_mode: str = "per_shard"):
        e = model.config.encoder
        variant = "diag" if e.name == "gcn_diag" else e.gcn_variant
        dense_input = e.name == "gcn_diag" or e.use_input_transform
        if not (model.is_gcn and dense_input
                and variant in SUPPORTED_VARIANTS
                and e.skip_connections == "None"
                and not model.variational and not model.has_state):
            raise ValueError(
                "VertexShardedEncoder supports the dense-input "
                f"{SUPPORTED_VARIANTS} variants without skip connections")
        if halo not in ("targeted", "all_gather"):
            raise ValueError(f"unknown halo mode {halo!r}")
        if dropout_mode not in ("per_shard", "full_parity"):
            raise ValueError(f"unknown dropout_mode {dropout_mode!r}")
        if overlap and halo != "targeted":
            raise ValueError("overlap requires halo='targeted'")
        self.fused = variant in ("block", "basis") and not overlap
        # The fused route's message precision follows the model's (JAX
        # ``_agg_dtype``); the unfused routes sum in f32, as JAX's
        # segment sum does.
        self._agg_dtype = model.agg_dtype
        self.model = model
        self.mesh = mesh
        self.halo = halo
        self.overlap = overlap
        self.dropout_mode = dropout_mode
        self.variant = variant
        self.n_shards = mesh.world_size
        self.rows_per = -(-model.n_entities // self.n_shards)
        self.v_pad = self.rows_per * self.n_shards

    # -- host layouts -------------------------------------------------------
    def prepare(self, triples: np.ndarray, pad_to: int,
                halo_budget: Optional[int] = None):
        """(forward arrays, backward arrays) of the message graph
        ``triples`` (``:323-358``): each the 7-tuple (senders, relations,
        receivers, mask, norm [n, pad_to], send_idx [n, n, h], src_ptr
        [n, pad_to]) of every shard, the JAX package's numpy arrays.
        ``shard_graph`` lays a rank's part out for the kernels. Sets
        ``traffic``: each direction's ``halo_traffic_rows``."""
        f, b, _ = partition_edges_by_destination(
            triples, self.model.n_entities, self.n_shards, pad_to,
            self.model.n_relations)
        f_sen, f_rel, f_rec, f_msk, f_nrm = f
        b_sen, b_rel, b_rec, b_msk, b_nrm = b
        # forward messages read senders, backward ones receivers
        f_halo, f_ptr = build_halo(f_sen, f_msk, self.rows_per,
                                   self.n_shards, self.model.n_entities,
                                   h_budget=halo_budget)
        b_halo, b_ptr = build_halo(b_rec, b_msk, self.rows_per,
                                   self.n_shards, self.model.n_entities,
                                   h_budget=halo_budget)
        self.traffic = (halo_traffic_rows(f_halo, self.rows_per,
                                           self.n_shards),
                         halo_traffic_rows(b_halo, self.rows_per,
                                           self.n_shards))
        return ((f_sen, f_rel, f_rec, f_msk, f_nrm, f_halo.send_idx, f_ptr),
                (b_sen, b_rel, b_rec, b_msk, b_nrm, b_halo.send_idx, b_ptr))

    def shard_graph(self, f_arrays, b_arrays,
                    rank: Optional[int] = None) -> ShardGraph:
        """Rank ``rank``'s (this rank's by default) layouts of ``prepare``'s
        arrays, on the host."""
        rank = self.mesh.rank if rank is None else rank
        return ShardGraph(self._direction(f_arrays, "sender", rank),
                          self._direction(b_arrays, "receiver", rank))

    def _direction(self, arrays, gather_col: str, s: int) -> ShardDirection:
        """One direction's rectangular layouts on shard ``s`` (in place of
        the JAX package's TPU slot layouts, ``:360-416``): the CSR by owned
        row [0, rows_per) whose sources index the halo buffer (targeted:
        the pointers, n * h + rows_per rows) or the gathered table
        (v_pad rows), and its twin by source row with the same weights.
        Padding edges (weight 0) are dropped."""
        sen, rel, rec, msk, nrm, send, ptr = arrays
        n, rows_per = self.n_shards, self.rows_per
        dest = (rec if gather_col == "sender" else sen)[s].astype(np.int64) \
            - s * rows_per
        if self.halo == "targeted":
            src = ptr[s].astype(np.int64)
            n_remote = n * send.shape[-1]
            n_src = n_remote + rows_per
            send_idx = _long(send[s])
        else:
            raw = sen if gather_col == "sender" else rec
            src = np.minimum(raw[s], self.v_pad - 1).astype(np.int64)
            n_remote, n_src, send_idx = 0, self.v_pad, None
        w = (nrm[s] * msk[s]).astype(np.float32)
        csr, _ = build_csr(src, rel[s], dest, w, rows_per, n_sources=n_src)
        twin = None
        if self.fused:
            twin, _ = build_csr(dest, rel[s], src, w, n_src,
                                n_sources=rows_per)
        return ShardDirection(csr, twin, send_idx, n_remote)

    def probe_budgets(self, sample_fn) -> dict:
        """dict(edge_pad, halo_budget, dec_halo_budget, t_pad) from
        ``PROBES`` samples of ``sample_fn() -> (graph triples, loss
        triples or (positives, corrupted values))``, times ``SLACK``
        (``:418-490``, at its defaults)."""
        max_edges = max_h = max_dec_h = max_t = 8
        for _ in range(PROBES):
            triples, loss_x = sample_fn()
            triples = np.asarray(triples, dtype=np.int64)
            factored = isinstance(loss_x, tuple)
            if factored:
                pos, vals = (np.asarray(a, dtype=np.int64) for a in loss_x)
                loss_x = pos
            else:
                loss_x = np.asarray(loss_x, dtype=np.int64)
            max_t = max(max_t, len(loss_x))
            for col in (2, 0):
                per = np.bincount(triples[:, col] // self.rows_per,
                                  minlength=self.n_shards)
                max_edges = max(max_edges, int(per.max()))
            for src_col, dst_col in ((0, 2), (2, 0)):
                dst_shard = triples[:, dst_col] // self.rows_per
                src = triples[:, src_col]
                for d in range(self.n_shards):
                    mine = src[dst_shard == d]
                    owners = mine // self.rows_per
                    for q in range(self.n_shards):
                        if q != d:
                            max_h = max(max_h,
                                        len(np.unique(mine[owners == q])))
            t_loc = _round_up(len(loss_x), self.n_shards * 8) \
                // self.n_shards
            for d in range(self.n_shards):
                sl = loss_x[d * t_loc:(d + 1) * t_loc]
                ents = [sl[:, 0], sl[:, 2]]
                if factored:
                    ents.append(vals[d * t_loc:(d + 1) * t_loc].reshape(-1))
                ents = np.concatenate(ents)
                owners = ents // self.rows_per
                for q in range(self.n_shards):
                    if q != d:
                        max_dec_h = max(max_dec_h,
                                        len(np.unique(ents[owners == q])))
        cap = _round_up(self.rows_per, 8)
        return {
            "edge_pad": _round_up(int(max_edges * SLACK), 8),
            "halo_budget": min(_round_up(int(max_h * SLACK), 8), cap),
            "dec_halo_budget": min(_round_up(int(max_dec_h * SLACK), 8),
                                   cap),
            "t_pad": _round_up(int(max_t), self.n_shards * 8),
        }

    # -- the parameters -----------------------------------------------------
    def pad_params(self, params):
        """A copy of ``params`` whose entity table has v_pad rows, zeros
        below V (``:492-501``)."""
        out = map_tree(torch.clone, params)
        w = out["input_transform"]["W"]
        pad = self.v_pad - w.shape[0]
        if pad:
            out["input_transform"]["W"] = torch.cat(
                [w, w.new_zeros(pad, w.shape[1])])
        return out

    def unpad_params(self, params):
        """The one-device params of a padded tree: the table's first V
        rows (``:519-526``)."""
        out = dict(params)
        out["input_transform"] = dict(params["input_transform"])
        out["input_transform"]["W"] = \
            params["input_transform"]["W"][:self.model.n_entities]
        return out

    def _rows(self) -> slice:
        r = self.mesh.rank
        return slice(r * self.rows_per, (r + 1) * self.rows_per)

    def place_state(self, tree):
        """This rank's state from a padded tree (params or optimizer
        state, as every rank holds it): rank 0's tree on every rank, on the
        mesh's device (``mesh.replicate``), then this rank's rows of the
        entity table and its moments (``:503-517``)."""
        tree = replicate(self.mesh, tree)
        rows = self._rows()
        leaves = [leaf[rows].contiguous() if sharded else leaf
                  for leaf, sharded in zip(tree_leaves(tree),
                                           table_mask(tree))]
        return tree_unflatten(tree, leaves)

    def gather_state(self, tree):
        """The padded tree from every rank's state: the table's (and its
        moments') v_pad rows gathered in rank order, the rest as they are.
        Every rank calls it; each gets the whole tree."""
        with torch.no_grad():
            leaves = [all_gather_rows(leaf, self.mesh.group) if sharded
                      else leaf for leaf, sharded in zip(tree_leaves(tree),
                                                         table_mask(tree))]
        return tree_unflatten(tree, leaves)

    def local_params(self, params):
        """This rank's params from a tree with its rows_per table rows, or
        with V or v_pad rows (one-device or padded params)."""
        w = params["input_transform"]["W"]
        if w.shape[0] == self.rows_per:
            return params
        if w.shape[0] == self.model.n_entities:
            params = self.pad_params(params)
        out = dict(params)
        out["input_transform"] = dict(params["input_transform"])
        out["input_transform"]["W"] = \
            params["input_transform"]["W"][self._rows()]
        return out

    # -- the encode ---------------------------------------------------------
    def shard_keep_masks(self, masks) -> list:
        """This rank's rows of one-device keep-masks [V, d] (padding rows
        kept), the ``'full_parity'`` masks."""
        v = self.model.n_entities
        return [torch.cat([m, m.new_ones(self.v_pad - v, m.shape[1])])
                [self._rows()] for m in masks]

    def draw_keep_masks(self, shared: torch.Generator,
                        rank: torch.Generator) -> list:
        """One keep-mask [rows_per, d] a layer: 'full_parity' the rows of
        the one-device masks drawn from ``shared`` (the same on every
        rank), 'per_shard' a mask of the rank's rows from ``rank``."""
        if self.dropout_mode == "full_parity":
            return self.shard_keep_masks(self.model.draw_keep_masks(shared))
        e = self.model.config.encoder
        return [enc.draw_keep_mask((self.rows_per, e.internal_dimension),
                                   e.dropout_keep_probability, rank)
                for _ in range(e.n_layers)]

    def local_encode(self, params, graph: ShardGraph,
                     keep_masks: Optional[list] = None,
                     deterministic: bool = True) -> torch.Tensor:
        """This rank's [rows_per, d] codes (``:539-700``); train mode
        (``deterministic`` false) drops the self-loop with
        ``keep_masks[layer]`` [rows_per, d]."""
        e = self.model.config.encoder
        group = self.mesh.group
        rows_per = self.rows_per
        feats = torch.relu(params["input_transform"]["W"]
                           + params["input_transform"]["b"])
        for li, lp in enumerate(params["gcn_layers"]):
            directions = ((graph.fwd, "forward"), (graph.bwd, "backward"))
            if self.overlap:
                # Both exchanges go out first; the local-source messages
                # and the self-loop are computed while the rows travel.
                arrivals = [halo_exchange_remote(feats, d.send_idx, group)
                            for d, _ in directions]
                near = [self._near_messages(lp, feats, d, sfx)
                        for d, sfx in directions]
            self_loop = torch.matmul(feats, lp["W_self"])
            if not deterministic:
                keep = e.dropout_keep_probability
                self_loop = torch.where(keep_masks[li].to(self_loop.device),
                                        self_loop / keep,
                                        torch.zeros_like(self_loop))
            if self.overlap:
                coll = [self._overlapped(lp, arrive(), msgs, d, sfx)
                        for arrive, msgs, (d, sfx)
                        in zip(arrivals, near, directions)]
            else:
                if self.halo == "targeted":
                    tables = [halo_exchange(feats, d.send_idx, group)
                              for d, _ in directions]
                else:
                    full = all_gather_rows(feats, group)
                    tables = [full, full]
                coll = [self._aggregate(lp, table, d, sfx)
                        for table, (d, sfx) in zip(tables, directions)]
            out = coll[0] + coll[1] + self_loop
            if self.variant in ("diag", "basis_plus_diag",
                                "basis_times_diag"):
                out = out + lp["b"]  # the block and basis layers never add it
            if li < e.n_layers - 1:
                out = torch.relu(out)
            feats = out
        if e.use_output_transform:
            ot = params["output_transform"]
            feats = torch.matmul(feats, ot["W"]) + ot["b"]
        return feats

    def _aggregate(self, lp, table, direction: ShardDirection, sfx: str):
        """One direction's sum into the owned rows from ``table``: the
        fused kernel (block, basis) with its twin, or per-edge messages
        summed by kernel 3."""
        if self.fused and self.variant == "block":
            return staircase2.block_direction(
                table, lp[f"W_{sfx}"], direction.csr, self.rows_per,
                direction.twin, self._agg_dtype)
        if self.fused:
            return staircase2.basis_direction(
                table, lp[f"W_{sfx}"].flatten(1), lp[f"C_{sfx}"],
                direction.csr, self.rows_per, direction.twin,
                self._agg_dtype)
        msgs = enc._edge_messages(lp, self.variant, table, direction.csr,
                                  sfx)
        return staircase.staircase_aggregate(msgs, direction.csr,
                                             self.rows_per)

    def _near_messages(self, lp, feats, direction: ShardDirection,
                       sfx: str) -> torch.Tensor:
        """The overlapped schedule's local-source messages (``:568-596``):
        every entry's message read from the rank's own rows ``feats``,
        masked to the entries whose source is local (JAX's arithmetic: the
        message work of every edge, here and in ``_overlapped``)."""
        csr, n_remote = direction.csr, direction.n_remote
        local = csr.src >= n_remote
        near = replace(csr, src=torch.where(local, csr.src - n_remote,
                                            torch.zeros_like(csr.src)))
        return enc._edge_messages(lp, self.variant, feats, near, sfx) \
            * local[:, None]

    def _overlapped(self, lp, remote, near, direction: ShardDirection,
                    sfx: str):
        """The overlapped schedule's sum: the local-source messages
        ``near`` plus those of the remote-source entries from the
        exchanged rows ``remote``, masked to them, then kernel 3."""
        csr = direction.csr
        local = csr.src >= direction.n_remote
        far = replace(csr, src=torch.where(local, torch.zeros_like(csr.src),
                                           csr.src))
        msgs = near + enc._edge_messages(lp, self.variant, remote, far,
                                         sfx) * ~local[:, None]
        return staircase.staircase_aggregate(msgs, csr, self.rows_per)

    # -- the loss batches ---------------------------------------------------
    def prepare_batch(self, x: np.ndarray, y: np.ndarray,
                      t_pad: Optional[int] = None,
                      halo_budget: Optional[int] = None):
        """A host-tiled loss batch in per-shard slices with its decoder
        halo (``:732-765``): (triples [n, T, 3], labels [n, T], mask
        [n, T], dec_send [n, n, h], e1_ptr [n, T], e2_ptr [n, T])."""
        n = self.n_shards
        if t_pad is None:
            t_pad = _round_up(len(x), n * 8)
        elif len(x) > t_pad:
            raise ValueError(f"batch of {len(x)} loss triples > static "
                             f"t_pad {t_pad}")
        xt = np.zeros((t_pad, 3), np.int32)
        yt = np.zeros((t_pad,), np.float32)
        mt = np.zeros((t_pad,), np.float32)
        xt[:len(x)] = x
        yt[:len(y)] = y
        mt[:len(x)] = 1.0
        t_loc = t_pad // n
        xt = xt.reshape(n, t_loc, 3)
        yt = yt.reshape(n, t_loc)
        mt = mt.reshape(n, t_loc)
        ents = np.concatenate([xt[:, :, 0], xt[:, :, 2]], axis=1)
        emask = np.concatenate([mt, mt], axis=1)
        halo, ptr = build_halo(ents, emask, self.rows_per, self.n_shards,
                               self.model.n_entities, h_budget=halo_budget)
        return xt, yt, mt, halo.send_idx, ptr[:, :t_loc], ptr[:, t_loc:]

    def prepare_batch_factored(self, x: np.ndarray, values: np.ndarray,
                               corrupt_object: np.ndarray,
                               t_pad: Optional[int] = None,
                               halo_budget: Optional[int] = None):
        """A factored binomial batch (``:767-812``): per-shard positives
        and their host-drawn corruption parts, the corrupted ids riding
        the decoder halo: (triples [n, T, 3], mask [n, T], values
        [n, T, k], corrupt [n, T, k], dec_send, e1_ptr [n, T], e2_ptr
        [n, T], ev_ptr [n, T, k])."""
        n = self.n_shards
        k = values.shape[1]
        if t_pad is None:
            t_pad = _round_up(len(x), n * 8)
        elif len(x) > t_pad:
            raise ValueError(f"batch of {len(x)} positives > static "
                             f"t_pad {t_pad}")
        xt = np.zeros((t_pad, 3), np.int32)
        mt = np.zeros((t_pad,), np.float32)
        vt = np.zeros((t_pad, k), np.int32)
        ct = np.zeros((t_pad, k), bool)
        xt[:len(x)] = x
        mt[:len(x)] = 1.0
        vt[:len(x)] = values
        ct[:len(x)] = corrupt_object
        t_loc = t_pad // n
        xt = xt.reshape(n, t_loc, 3)
        mt = mt.reshape(n, t_loc)
        vt = vt.reshape(n, t_loc, k)
        ct = ct.reshape(n, t_loc, k)
        ents = np.concatenate(
            [xt[:, :, 0], xt[:, :, 2], vt.reshape(n, t_loc * k)], axis=1)
        emask = np.concatenate([mt, mt, np.repeat(mt, k, axis=1)], axis=1)
        halo, ptr = build_halo(ents, emask, self.rows_per, self.n_shards,
                               self.model.n_entities, h_budget=halo_budget)
        return (xt, mt, vt, ct, halo.send_idx, ptr[:, :t_loc],
                ptr[:, t_loc:2 * t_loc], ptr[:, 2 * t_loc:].reshape(n, t_loc,
                                                                     k))

    def shard_loss(self, batch: "VSBatch",
                   rank: Optional[int] = None) -> ShardLoss:
        """Rank ``rank``'s (this rank's by default) slice of a ``VSBatch``,
        as host tensors."""
        s = self.mesh.rank if rank is None else rank

        def opt(a, fn=_long):
            return None if a is None else fn(a[s])
        return ShardLoss(
            _long(batch.triples[s]),
            opt(batch.labels, lambda a: torch.from_numpy(a.copy())),
            torch.from_numpy(batch.mask[s].copy()), _long(batch.dec_send[s]),
            _long(batch.e1_ptr[s]), _long(batch.e2_ptr[s]),
            opt(batch.neg_values),
            opt(batch.corrupt_object, lambda a: torch.from_numpy(a.copy())),
            opt(batch.ev_ptr))

    # -- the losses and the step -------------------------------------------
    def loss(self, params, graph: ShardGraph, batch: ShardLoss,
             keep_masks: Optional[list] = None,
             deterministic: bool = False) -> torch.Tensor:
        """The global loss, on every rank, from this rank's slices: the
        tiled loss (``loss_fn``, ``:814-851``) or, for a factored batch,
        the factored binomial loss (``loss_fn_factored``, ``:853-907``),
        on codes gathered through the decoder halo."""
        group = self.mesh.group
        decoder = self.model.decoder
        codes = self.local_encode(params, graph, keep_masks, deterministic)
        halo = halo_exchange(codes, batch.dec_send, group)
        e1 = take_rows(halo, batch.e1_ptr)
        e2 = take_rows(halo, batch.e2_ptr)
        r = take_rows(params["relation_embedding"]["W_relation"],
                      batch.triples[:, 1])
        dp = params["decoder"]
        pos_energy = decoder.energies(dp, e1, r, e2)
        if not batch.factored:
            return (decoders_lib.weighted_ce_loss(pos_energy, batch.labels,
                                                  batch.mask, group)
                    + decoder.regularization(dp, e1, r, e2, batch.mask,
                                             group))
        neg_energy, ev_sq = factored_negative_energies(
            halo, decoder.subject_factor(dp, r, e2),
            decoder.object_factor(dp, e1, r), batch.ev_ptr,
            batch.corrupt_object)
        return binomial_factored_objective(
            decoder, pos_energy, neg_energy, ev_sq, e1, r, e2, batch.mask,
            batch.corrupt_object, group)

    def reduce_grads(self, grads):
        """The gradient of the global loss from this rank's backward
        (module docstring): the replicated leaves' mean over the ranks
        (one all-reduce), the table's rows divided by the world size."""
        leaves, mask = tree_leaves(grads), table_mask(grads)
        shared = iter(pmean([g for g, m in zip(leaves, mask) if not m],
                            self.mesh.group))
        return tree_unflatten(grads, [g / self.n_shards if m
                                      else next(shared)
                                      for g, m in zip(leaves, mask)])

    def sum_of_squares(self, tree) -> Callable:
        """The clip's global sum of squares of leaves shaped as ``tree``'s:
        the replicated leaves' once, plus the table's all-reduced over the
        ranks."""
        mask = table_mask(tree)

        def total(leaves):
            rep = sum((g * g).sum() for g, m in zip(leaves, mask) if not m)
            table = sum((g * g).sum() for g, m in zip(leaves, mask) if m)
            return rep + all_reduce_sum(table, self.mesh.group)
        return total

    def loss_and_grads(self, params, batch: VSRankBatch,
                       keep_masks: Optional[list]) -> tuple:
        """(global loss, gradient tree of the global loss: the table's
        leaf this rank's rows)."""
        from ..training.engine import _value_and_grad
        loss, grads = _value_and_grad(
            lambda: self.loss(params, batch.graph, batch.loss, keep_masks),
            params)
        return loss, self.reduce_grads(grads)

    def make_train_step(self, optimizer) -> Callable:
        """``step(params, opt_state, batch, keep_masks) -> (opt_state,
        loss)`` on this rank's state (``:909-944``): the loss and the
        reduced gradients, the optimizer with the clip's global sum of
        squares, the update applied to ``params`` in place."""
        from ..training.optimizers import apply_updates

        def step(params, opt_state, batch, keep_masks):
            loss, grads = self.loss_and_grads(params, batch, keep_masks)
            updates, opt_state = optimizer.update(
                grads, opt_state, sum_of_squares=self.sum_of_squares(grads))
            apply_updates(params, updates)
            return opt_state, loss
        return step


class VSBatch(NamedTuple):
    """One training batch of every shard, laid out to the pipeline's
    budgets (``:947-964``): the JAX package's numpy arrays."""

    f_arrays: tuple
    b_arrays: tuple
    triples: np.ndarray
    labels: Optional[np.ndarray]   # None in factored mode
    mask: np.ndarray
    dec_send: np.ndarray
    e1_ptr: np.ndarray
    e2_ptr: np.ndarray
    neg_values: Optional[np.ndarray] = None
    corrupt_object: Optional[np.ndarray] = None
    ev_ptr: Optional[np.ndarray] = None


class VertexShardedBatchPipeline:
    """Host batches of the vertex-sharded step (``:967-1072``): the subgraph
    and its positives drawn by ``sampling.draw_subgraph``, as
    ``engine.BatchPipeline`` draws them, laid out to static budgets (probed at
    construction from their own generator, 0xB0D6E7, unless ``budgets`` is
    given); factored draws (``factored``: a corrupted entity and a coin a slot,
    riding the decoder halo) or the host-tiled batch. A batch whose halo
    exceeds its budget raises ValueError, as in the JAX package.

    ``next()`` gives the ``VSBatch`` of every shard; with ``shard_rank``
    it gives that rank's ``VSRankBatch`` (its CSRs alone), pinned where
    the model is on the card."""

    def __init__(self, vse: VertexShardedEncoder, config, dataset,
                 rng: np.random.Generator, sampler: str = "neighborhood",
                 budgets: Optional[dict] = None, factored: bool = False,
                 shard_rank: Optional[int] = None):
        self.vse = vse
        self.config = config
        self.train = np.asarray(dataset.train, dtype=np.int32)
        self.rng = rng
        self.sampler = sampler
        t = config.training
        n_train = len(self.train)
        gbs = t.graph_batch_size or n_train
        self.graph_batch_size = min(gbs, n_train)
        self.split_size = int(t.graph_split_size * self.graph_batch_size)
        self.n_positives = self.graph_batch_size
        self.adj = AdjacencyIndex(self.train, config.entity_count)
        self.ns = NegativeSampler(t.negative_sample_rate,
                                  config.entity_count, rng)
        self.factored = factored
        self.shard_rank = shard_rank
        self.pin = vse.model.device.type == "cuda"

        if budgets is None:
            probe_rng = np.random.default_rng(0xB0D6E7)
            probe_ns = NegativeSampler(t.negative_sample_rate,
                                       config.entity_count, probe_rng)

            def sample_fn():
                ids, split = self._draw(probe_rng)
                if factored:
                    pos = self.train[ids]
                    vals = probe_rng.integers(
                        0, config.entity_count,
                        (len(pos), t.negative_sample_rate))
                    return self.train[split], (pos, vals)
                x, _ = probe_ns.transform(self.train[ids])
                return self.train[split], x

            budgets = vse.probe_budgets(sample_fn)
        self.budgets = budgets

    def _draw(self, rng) -> tuple:
        return draw_subgraph(self.train, self.adj, self.graph_batch_size,
                             self.config.training.graph_split_size,
                             self.sampler, rng)

    def next(self):
        t = self.config.training
        ids, split = self._draw(self.rng)
        b = self.budgets
        f_arrays, b_arrays = self.vse.prepare(
            self.train[split], pad_to=b["edge_pad"],
            halo_budget=b["halo_budget"])
        if self.factored:
            pos = self.train[ids]
            k = t.negative_sample_rate
            vals = self.rng.integers(0, self.config.entity_count,
                                     (len(pos), k)).astype(np.int32)
            co = self.rng.random((len(pos), k)) < 0.5
            (xt, mt, vt, ct, dec_send, e1_ptr, e2_ptr,
             ev_ptr) = self.vse.prepare_batch_factored(
                pos, vals, co, t_pad=b["t_pad"],
                halo_budget=b["dec_halo_budget"])
            batch = VSBatch(f_arrays, b_arrays, xt, None, mt, dec_send,
                            e1_ptr, e2_ptr, neg_values=vt,
                            corrupt_object=ct, ev_ptr=ev_ptr)
        else:
            x, y = self.ns.transform(self.train[ids])
            xt, yt, mt, dec_send, e1_ptr, e2_ptr = self.vse.prepare_batch(
                x, y, t_pad=b["t_pad"], halo_budget=b["dec_halo_budget"])
            batch = VSBatch(f_arrays, b_arrays, xt, yt, mt, dec_send,
                            e1_ptr, e2_ptr)
        if self.shard_rank is None:
            return batch
        rank_batch = VSRankBatch(
            self.vse.shard_graph(f_arrays, b_arrays, self.shard_rank),
            self.vse.shard_loss(batch, self.shard_rank))
        return rank_batch.pin_memory() if self.pin else rank_batch

    # resumable host state (the contract of engine.BatchPipeline)
    def state(self) -> dict:
        return {"rng": self.rng.bit_generator.state, "cursor": 0}

    def set_state(self, st: dict) -> None:
        self.rng.bit_generator.state = st["rng"]


class VertexShardedModelView:
    """The Scorer's view of a vertex-sharded encode (``:1075-1198``):
    ``score``, ``score_all_subjects``, ``score_all_objects`` and
    ``invalidate``, the ``graph`` argument ignored (the codes come from
    the whole train graph's arrays given here). Every rank calls each
    method in the same order.

    The codes stay row-sharded: the [V, d] table is never put on one rank.
    A chunk's e1 / e2 rows reach every rank by an all-reduce of the rows
    each rank owns, zeros elsewhere (an exact sum); each rank scores its
    [chunk, rows_per] block of candidates, and one all-gather gives
    [chunk, v_pad], cut to V. The encode is cached by the params object
    (``is``), a strong reference: a new tree re-encodes, an in-place
    update of the same tree needs ``invalidate()``. The params may be a
    rank's (rows_per table rows), one device's (V) or padded (v_pad)."""

    def __init__(self, vse: VertexShardedEncoder, f_arrays, b_arrays):
        self.vse = vse
        self.graph = vse.shard_graph(f_arrays, b_arrays).to(vse.mesh.device)
        self._key = None
        self._codes = None

    def invalidate(self) -> None:
        self._key = None
        self._codes = None

    def encoded(self, params) -> tuple:
        """(this rank's params, its [rows_per, d] test-mode codes), encoded
        once per params object."""
        if self._key is None or self._key is not params:
            local = self.vse.local_params(params)
            with torch.no_grad():
                self._codes = self.vse.local_encode(local, self.graph)
            self._local, self._key = local, params
        return self._local, self._codes

    def _rows_of(self, codes, ids) -> torch.Tensor:
        """codes[ids] of the global ids ``ids`` on every rank."""
        vse = self.vse
        owner = ids // vse.rows_per
        mine = owner == vse.mesh.rank
        rows = codes[torch.where(mine, ids % vse.rows_per,
                                 torch.zeros_like(ids))]
        rows = torch.where(mine[:, None], rows, torch.zeros_like(rows))
        return all_reduce_sum(rows, vse.mesh.group)

    def _triples(self, triples) -> torch.Tensor:
        return torch.as_tensor(np.asarray(triples), dtype=torch.long,
                               device=self.vse.mesh.device).reshape(-1, 3)

    def _all(self, params, triples, subjects: bool, apply_sigmoid: bool):
        with torch.no_grad():
            local, codes = self.encoded(params)
            t = self._triples(triples)
            dec, dp = self.vse.model.decoder, local["decoder"]
            r = local["relation_embedding"]["W_relation"][t[:, 1]]
            if subjects:
                block = dec.all_subject_energies(
                    dp, codes, r, self._rows_of(codes, t[:, 2]))
            else:
                block = dec.all_object_energies(
                    dp, codes, self._rows_of(codes, t[:, 0]), r)
            scores = all_gather_rows(block.T.contiguous(),
                                     self.vse.mesh.group).T
            scores = scores[:, :self.vse.model.n_entities]
            return torch.sigmoid(scores) if apply_sigmoid else scores

    def score_all_subjects(self, params, graph, triples,
                           apply_sigmoid: bool = True) -> torch.Tensor:
        return self._all(params, triples, True, apply_sigmoid)

    def score_all_objects(self, params, graph, triples,
                          apply_sigmoid: bool = True) -> torch.Tensor:
        return self._all(params, triples, False, apply_sigmoid)

    def score(self, params, graph, triples) -> torch.Tensor:
        with torch.no_grad():
            local, codes = self.encoded(params)
            t = self._triples(triples)
            r = local["relation_embedding"]["W_relation"][t[:, 1]]
            return torch.sigmoid(self.vse.model.decoder.energies(
                local["decoder"], self._rows_of(codes, t[:, 0]), r,
                self._rows_of(codes, t[:, 2])))


def eval_arrays(vse: VertexShardedEncoder, triples: np.ndarray):
    """``prepare``'s arrays of the whole graph ``triples`` for evaluation
    (JAX ``cli.py:145-156``): padded to the largest shard's edge count in
    either direction, rounded up to 8, with no halo budget."""
    triples = np.asarray(triples)
    per = [np.bincount(triples[:, col] // vse.rows_per,
                       minlength=vse.n_shards).max() for col in (2, 0)]
    return vse.prepare(triples, pad_to=_round_up(int(max(per)), 8))
