"""Encoder components as (init, apply) pairs over dictionaries of tensors.

Counterpart of ``relationprediction_tpu/models/encoders.py`` for what
``settings/gcn_block.exp`` and ``settings/gcn_basis.exp`` run, with or
without an input transform, and ``gcn_diag``: the affine input stage, the
relation embedding and the block-diagonal, basis-decomposition and diagonal
R-GCN layers. A layer takes one of two routes, as in the JAX package: the
fused one (``staircase2.block_direction`` / ``basis_direction``, TPU
kernels 1-2) for block and basis layers of a model with an input transform,
else per-edge messages aggregated by ``staircase.staircase_aggregate``
(TPU kernel 3). Other layer variants raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import exact_float32
from ..graph import GraphBatch
from ..ops import relblock, staircase, staircase2
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
# Message-passing GCN layer
# ---------------------------------------------------------------------------

PORTED_VARIANTS = ("block", "basis", "diag")


def not_ported(variant: str) -> NotImplementedError:
    return NotImplementedError(
        f"gcn variant {variant!r} is not ported yet "
        f"(ROADMAP.md Queue 1 item 2)")


def init_gcn_layer(generator: torch.Generator, variant: str, *,
                   n_relations: int, d_in: int, d_out: int, n_bases: int,
                   onehot_dim: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """One layer's parameters (``encoders.py:82-126``). ``onehot_dim``: the
    entity count, for a first layer that takes one-hot input; a basis
    layer's W_* and W_self then have one row per entity."""
    if variant not in PORTED_VARIANTS:
        raise not_ported(variant)
    if variant == "basis":
        feat_dim = onehot_dim if onehot_dim is not None else d_in
        g = init.glorot_std(feat_dim, d_out)
        return {
            "W_forward": init.normal(generator, (feat_dim, n_bases, d_out), g),
            "W_backward": init.normal(generator, (feat_dim, n_bases, d_out),
                                      g),
            "C_forward": init.normal(generator, (n_relations, n_bases), 1.0),
            "C_backward": init.normal(generator, (n_relations, n_bases),
                                      1.0),
            "W_self": init.normal(generator, (feat_dim, d_out), g),
            "b": init.zeros((d_out,), generator.device),  # unused (ref quirk)
        }
    if onehot_dim is not None:
        raise ValueError(f"the {variant} layer requires dense input (use an "
                         f"input transform before it)")
    if variant == "diag":
        g = init.glorot_std(d_in, d_out)
        return {
            "D_types_forward": init.normal(generator, (n_relations, d_out),
                                           1.0),
            "D_types_backward": init.normal(generator, (n_relations, d_out),
                                            1.0),
            "W_self": init.normal(generator, (d_in, d_out), g),
            "b": init.zeros((d_out,), generator.device),
        }
    if d_out % n_bases != 0:
        raise ValueError("block variant needs d_out % n_blocks == 0")
    dr = d_out // n_bases
    # glorot over (R, dr), the reference's odd fan choice
    # (``gcn_basis_concat.py:22``), for W_self too.
    g = init.glorot_std(n_relations, dr)
    return {
        "W_forward": init.normal(generator, (n_relations, n_bases, dr, dr), g),
        "W_backward": init.normal(generator, (n_relations, n_bases, dr, dr),
                                  g),
        "W_self": init.normal(generator, (d_in, d_out), g),
        "b": init.zeros((d_out,), generator.device),  # unused (ref quirk)
    }


def apply_gcn_layer(params: Dict[str, torch.Tensor], variant: str,
                    graph: GraphBatch, features: Optional[torch.Tensor], *,
                    fused: bool, use_nonlinearity: bool, dropout_keep: float,
                    deterministic: bool,
                    generator: Optional[torch.Generator],
                    n_vertices: int,
                    keep_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One R-GCN layer (``message_gcn.py:49-79``; ``encoders.py:242-354``):
    both directions, then the self-loop, the bias of a diag layer, then an
    optional ReLU. ``features`` None is one-hot input.

    With ``fused`` (the model's ``preferred_staircase2``), block and basis
    layers on dense input run ``staircase2.block_direction`` /
    ``basis_direction`` (differentiable through their twin layouts). Every
    other layer builds its messages per direction, in that direction's CSR
    order (``graph.fwd.src`` / ``rel``, ``graph.bwd.src`` / ``rel``), and
    sums them with ``staircase.staircase_aggregate``. ``keep_mask``: see
    ``_combine_with_self_loop``."""
    if variant not in PORTED_VARIANTS:
        raise not_ported(variant)
    if features is None and variant != "basis":
        raise ValueError(f"the {variant} layer requires dense input (use an "
                         f"input transform before it)")
    if fused and features is not None and variant == "block":
        collected_f = staircase2.block_direction(
            features, params["W_forward"], graph.fwd, n_vertices,
            graph.fwd_twin)
        collected_b = staircase2.block_direction(
            features, params["W_backward"], graph.bwd, n_vertices,
            graph.bwd_twin)
    elif fused and features is not None and variant == "basis":
        # [d_in, B, d_out] -> W_flat [d_in, B*d_out], a view
        # (``encoders.py:287-290``).
        collected_f = staircase2.basis_direction(
            features, params["W_forward"].flatten(1), params["C_forward"],
            graph.fwd, n_vertices, graph.fwd_twin)
        collected_b = staircase2.basis_direction(
            features, params["W_backward"].flatten(1), params["C_backward"],
            graph.bwd, n_vertices, graph.bwd_twin)
    else:
        collected_f, collected_b = (
            staircase.staircase_aggregate(
                _edge_messages(params, variant, features, layout, sfx),
                layout, n_vertices)
            for layout, sfx in ((graph.fwd, "forward"),
                                (graph.bwd, "backward")))
    return _combine_with_self_loop(
        params, variant, features, collected_f + collected_b,
        use_nonlinearity=use_nonlinearity, dropout_keep=dropout_keep,
        deterministic=deterministic, generator=generator,
        keep_mask=keep_mask)


def _edge_messages(params, variant, features, layout, sfx) -> torch.Tensor:
    """[E, d_out] messages of one direction in its CSR's entry order
    (``encoders.py:164-229``): W_<sfx>, C_<sfx> or D_types_<sfx>. Relation
    ids are not offset for the backward direction; it has its own
    weights (``gcn_basis.py:43-57``)."""
    if variant == "diag":
        return relblock.diag_messages(features, params[f"D_types_{sfx}"],
                                      layout.src, layout.rel)
    if variant == "basis":
        w = params[f"W_{sfx}"]
        proj = relblock.basis_vertex_projection(features, w.flatten(1),
                                                w.shape[1])
        return relblock.basis_messages(proj, params[f"C_{sfx}"], layout.src,
                                       layout.rel)
    raise ValueError(f"the {variant} layer has no unfused route in the "
                     f"port (its model has an input transform)")


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
    The diag variant adds its bias (``gcn_diag.py:50``); the block and
    basis variants create one but never add it (reference quirk).

    In train mode (``deterministic`` false) the self-loop gets dropout:
    ``keep_mask`` [V, d] bool where given (the tests feed the JAX
    package's draws), else a mask drawn from ``generator``."""
    self_loop = apply_affine({"W": params["W_self"]}, features,
                             use_bias=False)
    if not deterministic:
        if keep_mask is None:
            if generator is None:
                raise ValueError("train-mode dropout needs a keep-mask or "
                                 "a torch.Generator")
            keep_mask = draw_keep_mask(self_loop.shape, dropout_keep,
                                       generator)
        # tf.nn.dropout: keep w.p. p, scale kept values by 1/p; applied
        # only to the self-loop messages (``message_gcn.py:64``).
        self_loop = torch.where(keep_mask.to(self_loop.device),
                                self_loop / dropout_keep,
                                torch.zeros_like(self_loop))
    out = combined + self_loop
    if variant == "diag":
        out = out + params["b"]
    if use_nonlinearity:
        out = torch.relu(out)
    return out
