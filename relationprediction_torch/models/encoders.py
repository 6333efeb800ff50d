"""Encoder components as (init, apply) pairs over dictionaries of tensors.

Counterpart of ``relationprediction_tpu/models/encoders.py``, all of it:
the affine stages (input, output, variational projections), the relation
embedding, the random vertex embedding, every R-GCN layer variant (block,
basis, diag, basis_plus_diag, basis_times_diag, only_bias, basis_stored
with its stored-message state), and the highway, residual, dropover and
variational wrappers; and the port's own CompGCN layer (``ccorr``,
``apply_compgcn_layer``). An R-GCN layer takes one of two routes: the fused one
(``staircase2.block_direction`` / ``basis_direction``, TPU kernels 1-2)
for block and basis layers on dense input where the model asks for it,
else per-edge messages aggregated by ``staircase.staircase_aggregate``
(TPU kernel 3). Every random draw (dropout keep-masks, random input, the
dropover choice, the variational noise) is a tensor argument or is drawn
from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..device import exact_float32
from ..graph import CompGCNGraph, GraphBatch
from ..observability import span
from ..ops import relblock, staircase, staircase2
from ..ops.gather import take_rows
from ..parallel.collectives import all_reduce_sum, graph_shard_matches
from . import initializers as init


# ---------------------------------------------------------------------------
# Affine transform (embedding table / input stage)
# ---------------------------------------------------------------------------

def init_affine(generator: torch.Generator, shape,
                use_bias: bool = True) -> Dict[str, torch.Tensor]:
    """AffineTransform weights (``affine_transform.py:24-28``)."""
    std = init.glorot_std(shape[0], shape[1])
    params = {"W": init.normal(generator, shape, std)}
    if use_bias:
        params["b"] = init.zeros((shape[1],), generator.device)
    return params


def apply_affine(params: Dict[str, torch.Tensor], x: Optional[torch.Tensor],
                 *, onehot_input: bool = False, use_bias: bool = True,
                 use_nonlinearity: bool = False) -> torch.Tensor:
    """``affine_transform.py:33-60``: with one-hot input the weight matrix
    itself is the embedding table; otherwise a dense matmul."""
    if onehot_input or x is None:
        hidden = params["W"]
    else:
        exact_float32()
        hidden = torch.matmul(x, params["W"])
    if use_bias:
        hidden = hidden + params["b"]
    if use_nonlinearity:
        hidden = torch.relu(hidden)
    return hidden


# ---------------------------------------------------------------------------
# Relation embedding
# ---------------------------------------------------------------------------

def init_relation_embedding(generator: torch.Generator, n_relations: int,
                            dim: int) -> Dict[str, torch.Tensor]:
    """N(0,1) init (``relation_embedding.py:15-18``)."""
    return {"W_relation": init.normal(generator, (n_relations, dim), 1.0)}


# ---------------------------------------------------------------------------
# Random vertex embedding (ablation input)
# ---------------------------------------------------------------------------

def random_embedding(generator: torch.Generator, n_vertices: int,
                     dim: int) -> torch.Tensor:
    """U(-1, 1) codes [V, dim] (``encoders.py:68-71``), drawn anew at every
    call like the reference's un-materialized ``tf.random_uniform``
    (``random_vertex_embedding.py:20-24``). The dropover choice is drawn
    the same way."""
    return torch.rand((n_vertices, dim), generator=generator,
                      device=generator.device) * 2.0 - 1.0


# ---------------------------------------------------------------------------
# Message-passing GCN layer
# ---------------------------------------------------------------------------

GCN_VARIANTS = ("basis", "block", "diag", "basis_plus_diag",
                "basis_times_diag", "only_bias", "basis_stored")
# Variants whose messages read x[src] itself, so they need dense input.
_DENSE_ONLY = ("block", "diag", "basis_plus_diag")
# Variants that add the layer bias b (``gcn_diag.py:50``); block and basis
# create one but never add it (reference quirk).
_ADDS_BIAS = ("diag", "basis_plus_diag", "basis_times_diag")


def init_gcn_layer(generator: torch.Generator, variant: str, *,
                   n_relations: int, d_in: int, d_out: int, n_bases: int,
                   onehot_dim: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """One layer's parameters (``encoders.py:82-153``). ``onehot_dim``: the
    entity count, for a first layer that takes one-hot input; the basis
    variants' W_* and W_self then have one row per entity."""
    if variant not in GCN_VARIANTS:
        raise ValueError(f"unknown gcn variant {variant!r}")
    dev = generator.device
    feat_dim = onehot_dim if onehot_dim is not None else d_in
    g = init.glorot_std(feat_dim, d_out)

    def normal(shape, std):
        return init.normal(generator, shape, std)

    if variant == "only_bias":
        gb = init.glorot_std(n_relations, d_out)
        return {"b_forward": normal((n_relations, d_out), gb),
                "b_backward": normal((n_relations, d_out), gb)}
    if variant in ("block", "diag") and onehot_dim is not None:
        raise ValueError(f"the {variant} layer requires dense input (use an "
                         f"input transform before it)")
    if variant == "diag":
        return {
            "D_types_forward": normal((n_relations, d_out), 1.0),
            "D_types_backward": normal((n_relations, d_out), 1.0),
            "W_self": normal((d_in, d_out), g),
            "b": init.zeros((d_out,), dev),
        }
    if variant == "block":
        if d_out % n_bases != 0:
            raise ValueError("block variant needs d_out % n_blocks == 0")
        dr = d_out // n_bases
        # glorot over (R, dr), the reference's odd fan choice
        # (``gcn_basis_concat.py:22``), for W_self too.
        gr = init.glorot_std(n_relations, dr)
        return {
            "W_forward": normal((n_relations, n_bases, dr, dr), gr),
            "W_backward": normal((n_relations, n_bases, dr, dr), gr),
            "W_self": normal((d_in, d_out), gr),
            "b": init.zeros((d_out,), dev),  # unused (ref quirk)
        }
    # basis, basis_stored (the same tree), basis_plus_diag,
    # basis_times_diag: bases [feat, B, d_out] and coefficients, [R, B]
    # or, for basis_times_diag, [R, B, d_out].
    coef = (n_relations, n_bases, d_out) if variant == "basis_times_diag" \
        else (n_relations, n_bases)
    params = {
        "W_forward": normal((feat_dim, n_bases, d_out), g),
        "W_backward": normal((feat_dim, n_bases, d_out), g),
        "C_forward": normal(coef, 1.0),
        "C_backward": normal(coef, 1.0),
    }
    if variant == "basis_plus_diag":
        params["D_types_forward"] = normal((n_relations, d_out), 1.0)
        params["D_types_backward"] = normal((n_relations, d_out), 1.0)
    params["W_self"] = normal((feat_dim, d_out), g)
    params["b"] = init.zeros((d_out,), dev)
    return params


def apply_gcn_layer(params: Dict[str, torch.Tensor], variant: str,
                    graph: GraphBatch, features: Optional[torch.Tensor], *,
                    fused: bool, use_nonlinearity: bool, dropout_keep: float,
                    deterministic: bool,
                    generator: Optional[torch.Generator],
                    n_vertices: int,
                    keep_mask: Optional[torch.Tensor] = None,
                    agg_dtype: Optional[torch.dtype] = None,
                    group=None) -> torch.Tensor:
    """One R-GCN layer (``message_gcn.py:49-79``; ``encoders.py:242-354``):
    both directions, then the self-loop, the bias of the variants that add
    it, then an optional ReLU. ``features`` None is one-hot input.

    With ``fused`` (the model's ``preferred_staircase2``), block and basis
    layers on dense input run ``staircase2.block_direction`` /
    ``basis_direction`` (differentiable through their twin layouts). Every
    other layer builds its messages per direction, in that direction's CSR
    order (``graph.fwd.src`` / ``rel``, ``graph.bwd.src`` / ``rel``), and
    sums them with ``staircase.staircase_aggregate``, weighted by the
    graph's normalization, or with unit weights for basis_stored (its
    'none' normalization, ``encoders.py:319``). ``keep_mask``: see
    ``_combine_with_self_loop``. ``agg_dtype`` (torch.bfloat16 for the
    bf16 message precision, JAX's ``agg_dtype``) goes to the aggregation
    ops, which then run their bf16 kernels; the 'local' and 'none'
    normalizations (a graph built with them, or basis_stored's unit
    weights) sum in f32 whatever it says, as JAX's segment-sum path does
    (``encoders.py:328-345``).

    ``group`` (an edge mesh's process group): ``graph`` is this rank's
    shard of the edges, weighted over the whole graph
    (``graph.build_graph_batch(shard=...)``); on every route the partial
    sum of both directions is all-reduced before the self-loop, in the f32
    the aggregation produces (``encoders.py:297-299``, ``:348-350``), so
    each rank gets the whole graph's layer. Raises ValueError for a graph
    that is not the rank's shard, and for a shard without a group."""
    graph_shard_matches(graph, group)
    if graph.normalization != "global":
        agg_dtype = None
    if variant not in GCN_VARIANTS:
        raise ValueError(f"unknown gcn variant {variant!r}")
    if features is None and variant in _DENSE_ONLY:
        raise ValueError(f"the {variant} layer requires dense input (use an "
                         f"input transform before it)")
    if fused and features is not None and variant == "block":
        collected_f = staircase2.block_direction(
            features, params["W_forward"], graph.fwd, n_vertices,
            graph.fwd_twin, agg_dtype)
        collected_b = staircase2.block_direction(
            features, params["W_backward"], graph.bwd, n_vertices,
            graph.bwd_twin, agg_dtype)
    elif fused and features is not None and variant == "basis":
        # [d_in, B, d_out] -> W_flat [d_in, B*d_out], a view
        # (``encoders.py:287-290``).
        collected_f = staircase2.basis_direction(
            features, params["W_forward"].flatten(1), params["C_forward"],
            graph.fwd, n_vertices, graph.fwd_twin, agg_dtype)
        collected_b = staircase2.basis_direction(
            features, params["W_backward"].flatten(1), params["C_backward"],
            graph.bwd, n_vertices, graph.bwd_twin, agg_dtype)
    else:
        weighted = variant != "basis_stored"
        collected_f, collected_b = (
            staircase.staircase_aggregate(
                _edge_messages(params, variant, features, layout, sfx),
                layout, n_vertices, weighted=weighted,
                compute_dtype=agg_dtype if weighted else None)
            for layout, sfx in ((graph.fwd, "forward"),
                                (graph.bwd, "backward")))
    combined = collected_f + collected_b
    if group is not None:
        combined = all_reduce_sum(combined, group)
    return _combine_with_self_loop(
        params, variant, features, combined,
        use_nonlinearity=use_nonlinearity, dropout_keep=dropout_keep,
        deterministic=deterministic, generator=generator,
        keep_mask=keep_mask)


def _edge_messages(params, variant, features, layout, sfx) -> torch.Tensor:
    """[E, d_out] messages of one direction in its CSR's entry order
    (``encoders.py:164-229``): W_<sfx>, C_<sfx>, D_types_<sfx> or b_<sfx>.
    Relation ids are not offset for the backward direction; it has its own
    weights (``gcn_basis.py:43-57``)."""
    src, rel = layout.src, layout.rel
    if variant == "diag":
        return relblock.diag_messages(features, params[f"D_types_{sfx}"],
                                      src, rel)
    if variant == "only_bias":
        return relblock.relation_bias_messages(params[f"b_{sfx}"], rel)
    if variant == "block":
        return relblock.block_diag_messages(features, params[f"W_{sfx}"],
                                            src, rel)
    w = params[f"W_{sfx}"]
    proj = relblock.basis_vertex_projection(features, w.flatten(1),
                                            w.shape[1])
    if variant == "basis_times_diag":
        return relblock.basis_messages_scaled(proj, params[f"C_{sfx}"], src,
                                              rel)
    msgs = relblock.basis_messages(proj, params[f"C_{sfx}"], src, rel)
    if variant == "basis_plus_diag":
        # x[src] * D[r] (``gcn_basis_plus_diag.py:58-61``).
        msgs = msgs + relblock.diag_messages(
            features, params[f"D_types_{sfx}"], src, rel)
    return msgs


def draw_keep_mask(shape, dropout_keep: float,
                   generator: torch.Generator) -> torch.Tensor:
    """A dropout keep-mask: True with probability ``dropout_keep``."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device) < dropout_keep


def _combine_with_self_loop(params, variant, features, combined, *,
                            use_nonlinearity, dropout_keep, deterministic,
                            generator, keep_mask=None):
    """Self-loop + bias + nonlinearity tail (``encoders.py:357-380``). With
    one-hot input (``features`` None) the self-loop is the W_self table.
    only_bias has no self-loop (``gcn_only_bias.py:34-35``); diag,
    basis_plus_diag and basis_times_diag add their bias; the block and
    basis variants create one but never add it (reference quirk)."""
    if variant == "only_bias":
        out = combined
    else:
        out = combined + _self_loop(params, features, dropout_keep,
                                    deterministic, generator, keep_mask)
        if variant in _ADDS_BIAS:
            out = out + params["b"]
    if use_nonlinearity:
        out = torch.relu(out)
    return out


def _self_loop(params, features, dropout_keep, deterministic, generator,
               keep_mask):
    """x @ W_self (the W_self table for one-hot input). In train mode
    (``deterministic`` false) it gets dropout: ``keep_mask`` [V, d] bool
    where given (the tests feed the JAX package's draws), else a mask
    drawn from ``generator``."""
    self_loop = apply_affine({"W": params["W_self"]}, features,
                             use_bias=False)
    if deterministic:
        return self_loop
    if keep_mask is None:
        if generator is None:
            raise ValueError("train-mode dropout needs a keep-mask or a "
                             "torch.Generator")
        keep_mask = draw_keep_mask(self_loop.shape, dropout_keep, generator)
    # tf.nn.dropout: keep w.p. p, scale kept values by 1/p; applied only to
    # the self-loop messages (``message_gcn.py:64``).
    return torch.where(keep_mask.to(self_loop.device),
                       self_loop / dropout_keep, torch.zeros_like(self_loop))


# ---------------------------------------------------------------------------
# Stored-message (incremental) layer state, BasisGcnStore
# ---------------------------------------------------------------------------

def init_stored_state(n_edges_total: int, n_vertices: int, d: int,
                      device=None) -> Dict[str, torch.Tensor]:
    """Zero message and vertex caches (``gcn_basis_stored.py:33-35``,
    ``encoders.py:387-394``): [edge_count + 1, d] a direction, the last a
    phantom row, as in the JAX package (which points its padding edges
    there; the port's graphs have none, so it stays 0), and [V, d]."""
    def zeros(shape):
        return init.zeros(shape, device)
    return {"cached_messages_f": zeros((n_edges_total + 1, d)),
            "cached_messages_b": zeros((n_edges_total + 1, d)),
            "cached_vertex_embeddings": zeros((n_vertices, d))}


def apply_gcn_layer_stored(params: Dict[str, torch.Tensor],
                           state: Dict[str, torch.Tensor],
                           graph: GraphBatch,
                           features: Optional[torch.Tensor],
                           edge_ids: torch.Tensor, *,
                           use_nonlinearity: bool, dropout_keep: float,
                           deterministic: bool,
                           generator: Optional[torch.Generator],
                           n_vertices: int,
                           keep_mask: Optional[torch.Tensor] = None
                           ) -> tuple:
    """Train-mode BasisGcnStore layer (``gcn_basis_stored.py:91-112``,
    ``encoders.py:397-448``): sum only the delta between the batch edges'
    fresh basis messages and their cached ones, with unit weights, add
    the cached vertex state, then the self-loop (with dropout) and an
    optional ReLU; the basis bias is not added. Returns (vertex codes,
    new state).

    edge_ids: [E] ids into the train set of the graph's input edges
    (``TrainBatch.message_edge_ids``). Each direction takes its deltas in
    its own CSR order, cached row ``edge_ids[order[k]]`` for entry k
    (``graph.fwd_order``, ``bwd_order``), and sums them through
    ``staircase.staircase_aggregate`` with ``weighted=False``: forward by
    receiver, backward by sender. The new state is built outside autograd
    (JAX's ``stop_gradient``, ``build.py:252``); ``state`` is not
    changed."""
    new_state = {}
    collected = None
    for layout, order, sfx, key in (
            (graph.fwd, graph.fwd_order, "forward", "cached_messages_f"),
            (graph.bwd, graph.bwd_order, "backward", "cached_messages_b")):
        rows = edge_ids.long()[order.long()]
        fresh = _edge_messages(params, "basis", features, layout, sfx)
        cache = state[key]
        part = staircase.staircase_aggregate(fresh - cache[rows], layout,
                                             n_vertices, weighted=False)
        collected = part if collected is None else collected + part
        with torch.no_grad():
            new_state[key] = cache.index_copy(0, rows, fresh.detach())
    updated = collected + state["cached_vertex_embeddings"]
    new_state["cached_vertex_embeddings"] = updated.detach()
    out = updated + _self_loop(params, features, dropout_keep,
                               deterministic, generator, keep_mask)
    if use_nonlinearity:
        out = torch.relu(out)
    return out, new_state


# ---------------------------------------------------------------------------
# Highway / residual / dropover / variational wrappers
# ---------------------------------------------------------------------------

def init_highway(generator: torch.Generator,
                 shape) -> Dict[str, torch.Tensor]:
    """Gate weights, the bias initialised to ones (``highway_layer.py:
    27-31``, ``encoders.py:455-459``)."""
    std = init.glorot_std(shape[0], shape[1])
    return {"W": init.normal(generator, shape, std),
            "b": torch.ones((shape[1],), dtype=torch.float32,
                            device=generator.device)}


def apply_highway(params: Dict[str, torch.Tensor], code_new: torch.Tensor,
                  code_prev: torch.Tensor) -> torch.Tensor:
    """gates * new + (1 - gates) * prev, gates = sigmoid(prev @ W + b)
    (``highway_layer.py:14-38``)."""
    gates = torch.sigmoid(apply_affine(params, code_prev))
    return gates * code_new + (1.0 - gates) * code_prev


def apply_residual(code_new: torch.Tensor,
                   code_prev: torch.Tensor) -> torch.Tensor:
    """new + prev (``residual_layer.py:12-19``; the JAX package implements
    the documented intent, ``encoders.py:472-476``)."""
    return code_new + code_prev


def apply_dropover(choice: torch.Tensor, code_1: torch.Tensor,
                   code_2: torch.Tensor, deterministic: bool) -> torch.Tensor:
    """Elementwise random choice between two code matrices in train mode,
    the first in test mode (``dropover.py:13-24``): code_1 where
    ``choice`` (a U(-1, 1) draw of the codes' shape) is > 0."""
    if deterministic:
        return code_1
    return torch.where(choice > 0, code_1, code_2)


def apply_variational(eps: torch.Tensor, mu: torch.Tensor,
                      log_sigma: torch.Tensor) -> torch.Tensor:
    """z = mu + exp(log_sigma) * eps, ``eps`` an N(0, 1) draw of mu's
    shape (``variational_encoding.py:14-25``). The reference draws noise
    in test mode too, and so does the port's model."""
    return mu + torch.exp(log_sigma) * eps


def variational_kl_penalty(mu: torch.Tensor,
                           log_sigma: torch.Tensor) -> torch.Tensor:
    """-0.0005 * sum(1 + 2 log s - mu^2 - exp(2 log s))
    (``variational_encoding.py:27-31``)."""
    return -0.0005 * torch.sum(1.0 + 2.0 * log_sigma - mu ** 2
                               - torch.exp(2.0 * log_sigma))


# ---------------------------------------------------------------------------
# CompGCN (Vashishth et al., arXiv:1911.03082): the composition layer
# ---------------------------------------------------------------------------

def xavier_std(fan_in: int, fan_out: int) -> float:
    """``torch.nn.init.xavier_normal_``'s standard deviation, the official
    CompGCN code's ``get_param``."""
    return (2.0 / (fan_in + fan_out)) ** 0.5


def ccorr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular correlation over the last axis, out[..., k] = sum over i of
    a[..., i] b[..., (i + k) mod d], taken as the official code takes it:
    irfft(conj(rfft(a)) rfft(b)). Broadcasts the leading axes."""
    d = a.shape[-1]
    return torch.fft.irfft(torch.conj(torch.fft.rfft(a))
                           * torch.fft.rfft(b), n=d)


def dropped(x: torch.Tensor, keep_mask: torch.Tensor,
            drop: float) -> torch.Tensor:
    """Inverted dropout with an explicit keep-mask: x / (1 - drop) where
    kept, else 0."""
    return torch.where(keep_mask, x * (1.0 / (1.0 - drop)),
                       torch.zeros_like(x))


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               stats: Dict[str, torch.Tensor],
               training: bool) -> torch.Tensor:
    """``torch.nn.BatchNorm1d`` / ``2d`` at their defaults (momentum 0.1, eps
    1e-5) over the channels of axis 1: in training the batch's statistics,
    with ``stats``' running mean and variance updated in place; else the
    running ones."""
    return F.batch_norm(x, stats["mean"], stats["var"], weight, bias,
                        training=training, momentum=0.1, eps=1e-5)


def init_batch_stats(n: int, device) -> Dict[str, torch.Tensor]:
    return {"mean": torch.zeros(n, device=device),
            "var": torch.ones(n, device=device)}


def init_compgcn_layer(generator: torch.Generator, d_in: int,
                       d_out: int) -> Dict[str, torch.Tensor]:
    """``CompGCNConv``'s parameters: the in, out, self-loop and relation
    weights [d_in, d_out], the self-loop's relation [1, d_in] (xavier
    normal), BatchNorm's scale and shift."""
    dev = generator.device
    g = xavier_std(d_in, d_out)
    params = {f"W_{k}": init.normal(generator, (d_in, d_out), g)
              for k in ("in", "out", "loop", "rel")}
    params["loop_rel"] = init.normal(generator, (1, d_in),
                                     xavier_std(d_in, 1))
    params["bn_weight"] = torch.ones(d_out, device=dev)
    params["bn_bias"] = init.zeros((d_out,), dev)
    return params


def apply_compgcn_layer(params: Dict[str, torch.Tensor],
                        graph: CompGCNGraph, x: torch.Tensor,
                        z: torch.Tensor, stats: Dict[str, torch.Tensor], *,
                        layer_dropout: float, training: bool,
                        keep_masks: Optional[Sequence[torch.Tensor]] = None
                        ) -> tuple:
    """One ``CompGCNConv`` layer (corr): (entity codes [V, d_out], relation
    codes [2R, d_out]).

    Every message edge's W_half . ccorr(x_src, z_rel), the inward half's
    weights W_in and the outward's W_out, summed into its target weighted
    by the half's norm (``staircase.staircase_aggregate``); the self-loop
    W_loop . ccorr(x_v, loop_rel); out = (drop(in) + drop(out) + loop) / 3,
    BatchNorm over the entities, tanh. The
    relations become z W_rel. In training ``keep_masks`` holds the keep-
    masks [V, d_out] of the inward and outward sums; ``stats`` is the
    BatchNorm's running statistics. The gathers' gradients are summed by
    id over the graph's CSRs by source and by relation."""
    with span("encode.compose"):
        composed = ccorr(take_rows(x, graph.src_ids, graph.by_source),
                         take_rows(z, graph.rel_ids, graph.by_relation))
        e_in = graph.inward.n_edges
        exact_float32()
        msg_in = composed[:e_in] @ params["W_in"]
        msg_out = composed[e_in:] @ params["W_out"]
        loop = ccorr(x, params["loop_rel"]) @ params["W_loop"]
    with span("encode.aggregate"):
        n = x.shape[0]
        in_res = staircase.staircase_aggregate(msg_in, graph.inward, n)
        out_res = staircase.staircase_aggregate(msg_out, graph.outward, n)
    if keep_masks is not None:
        in_res = dropped(in_res, keep_masks[0], layer_dropout)
        out_res = dropped(out_res, keep_masks[1], layer_dropout)
    out = in_res * (1 / 3) + out_res * (1 / 3) + loop * (1 / 3)
    out = batch_norm(out, params["bn_weight"], params["bn_bias"], stats,
                     training)
    return torch.tanh(out), z @ params["W_rel"]
