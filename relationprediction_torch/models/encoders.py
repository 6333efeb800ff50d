"""Encoder components as (init, apply) pairs over dictionaries of tensors.

Counterpart of ``relationprediction_tpu/models/encoders.py`` for what
``settings/gcn_block.exp`` and ``settings/gcn_basis.exp`` run: the affine
input stage, the relation embedding and the block-diagonal and
basis-decomposition R-GCN layers on dense input. Other layer variants raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import exact_float32
from ..graph import GraphBatch
from ..ops import staircase2
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

PORTED_VARIANTS = ("block", "basis")


def not_ported(variant: str) -> NotImplementedError:
    return NotImplementedError(
        f"gcn variant {variant!r} is not ported yet "
        f"(ROADMAP.md Queue 1 item 6)")


def init_gcn_layer(generator: torch.Generator, variant: str, *,
                   n_relations: int, d_in: int, d_out: int,
                   n_bases: int) -> Dict[str, torch.Tensor]:
    """One dense-input layer's parameters (``encoders.py:94-118``)."""
    if variant not in PORTED_VARIANTS:
        raise not_ported(variant)
    if variant == "basis":
        g = init.glorot_std(d_in, d_out)
        return {
            "W_forward": init.normal(generator, (d_in, n_bases, d_out), g),
            "W_backward": init.normal(generator, (d_in, n_bases, d_out), g),
            "C_forward": init.normal(generator, (n_relations, n_bases), 1.0),
            "C_backward": init.normal(generator, (n_relations, n_bases),
                                      1.0),
            "W_self": init.normal(generator, (d_in, d_out), g),
            "b": init.zeros((d_out,), generator.device),  # unused (ref quirk)
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
                    graph: GraphBatch, features: torch.Tensor, *,
                    use_nonlinearity: bool, dropout_keep: float,
                    deterministic: bool,
                    generator: Optional[torch.Generator],
                    n_vertices: int,
                    keep_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One R-GCN layer (``message_gcn.py:49-79``; ``encoders.py:276-303``):
    both directions through ``staircase2.block_direction`` or
    ``staircase2.basis_direction`` (differentiable through their twin
    layouts), then the self-loop, then an optional ReLU. ``keep_mask``:
    see ``_combine_with_self_loop``."""
    if variant not in PORTED_VARIANTS:
        raise not_ported(variant)
    if features is None:
        raise ValueError(f"the {variant} layer requires dense input "
                         f"(use an input transform before it)")
    if variant == "block":
        collected_f = staircase2.block_direction(
            features, params["W_forward"], graph.fwd, n_vertices,
            graph.fwd_twin)
        collected_b = staircase2.block_direction(
            features, params["W_backward"], graph.bwd, n_vertices,
            graph.bwd_twin)
    else:
        # [d_in, B, d_out] -> W_flat [d_in, B*d_out], a view
        # (``encoders.py:287-290``).
        collected_f = staircase2.basis_direction(
            features, params["W_forward"].flatten(1), params["C_forward"],
            graph.fwd, n_vertices, graph.fwd_twin)
        collected_b = staircase2.basis_direction(
            features, params["W_backward"].flatten(1), params["C_backward"],
            graph.bwd, n_vertices, graph.bwd_twin)
    return _combine_with_self_loop(
        params, features, collected_f + collected_b,
        use_nonlinearity=use_nonlinearity, dropout_keep=dropout_keep,
        deterministic=deterministic, generator=generator,
        keep_mask=keep_mask)


def draw_keep_mask(shape, dropout_keep: float,
                   generator: torch.Generator) -> torch.Tensor:
    """A dropout keep-mask: True with probability ``dropout_keep``."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device) < dropout_keep


def _combine_with_self_loop(params, features, combined, *, use_nonlinearity,
                            dropout_keep, deterministic, generator,
                            keep_mask=None):
    """Self-loop + nonlinearity tail (``encoders.py:357-380``). The block
    and basis variants create a bias but never add it (reference quirk).

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
    if use_nonlinearity:
        out = torch.relu(out)
    return out
