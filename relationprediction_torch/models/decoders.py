"""Decoders (``relationprediction_tpu/models/decoders.py``): DistMult,
ComplEx and the MLP decoder, and the losses they share; and the port's own
ConvE scorer of CompGCN (``ConvE``), which scores a query against every
entity at once.

Scores exposed to evaluation are sigmoid(energies), as in the reference;
ranking is monotonic in the logits, so ranks are taken on the energies.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import CompGCNConfig
from ..device import exact_float32
from ..ops import sddmm
from ..parallel.collectives import all_reduce_sum
from . import initializers as init
from .encoders import batch_norm, dropped, init_batch_stats


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                group=None) -> torch.Tensor:
    """Mean over the entries where ``mask`` is 1 (``decoders.py:23-36``),
    with the count clamped to at least 1. The sum is f32 whatever the
    dtype of ``x`` (a bf16 stream's squares are summed in f32, as in the
    JAX package). With ``group`` (an edge mesh's process group, ``x`` this
    rank's rows) the sum and the count are all-reduced before the
    division: the mean over every rank's rows."""
    f32 = torch.float32
    if mask is None:
        total = x.sum(dtype=f32)
        count = torch.tensor(float(x.numel()), device=x.device)
    else:
        total = (x * mask.to(x.dtype)).sum(dtype=f32)
        count = mask.sum(dtype=f32)
    if group is not None:
        total, count = all_reduce_sum(torch.stack([total, count]), group)
    return total / count.clamp(min=1.0)


def weighted_ce_loss(energies: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     group=None) -> torch.Tensor:
    """Mean sigmoid cross-entropy with logits (``decoders.py:39-48``), in
    the stable form max(x, 0) - x*y + log1p(exp(-|x|)). The reference
    reads NegativeSampleRate as a positive-class weight and then overrides
    it to 1 (``bilinear_diag.py:32-33``), so the CE is unweighted.
    ``group``: see ``masked_mean``."""
    ce = (torch.clamp(energies, min=0.0) - energies * labels
          + torch.log1p(torch.exp(-energies.abs())))
    return masked_mean(ce, mask, group)


class BilinearDiag:
    """DistMult decoder (``decoders/bilinear_diag.py``)."""

    name = "bilinear-diag"

    def __init__(self, dimension: int, regularization_parameter: float):
        self.dimension = dimension
        self.regularization_parameter = regularization_parameter

    def init(self, generator: torch.Generator) -> Dict:
        return {}

    def energies(self, params, e1, r, e2):
        return sddmm.distmult_energies(e1, r, e2)

    def all_subject_energies(self, params, all_codes, r, e2):
        return sddmm.distmult_all_subjects(all_codes, r, e2)

    def all_object_energies(self, params, all_codes, e1, r):
        return sddmm.distmult_all_objects(all_codes, e1, r)

    # DistMult is linear in each entity code given the other two, so a
    # corrupted subject or object scores against one factor per positive
    # (``decoders.py:76-87``): energy(e1) = e1 . (r * e2),
    # energy(e2) = (e1 * r) . e2.
    factorizable = True

    def subject_factor(self, params, r, e2):
        """q with energy(candidate subject e) = e . q."""
        return r * e2

    def object_factor(self, params, e1, r):
        return e1 * r

    def regularization(self, params, e1, r, e2, mask=None, group=None):
        """reg_param * (mean e1^2 + mean r^2 + mean e2^2) over the batch
        codes (``bilinear_diag.py:63-69``); ``group``: see
        ``masked_mean``."""
        m = None if mask is None else mask[:, None] * torch.ones_like(e1)
        reg = (masked_mean(e1 ** 2, m, group) + masked_mean(r ** 2, m, group)
               + masked_mean(e2 ** 2, m, group))
        return self.regularization_parameter * reg


class Complex(BilinearDiag):
    """ComplEx decoder (``decoders/complex.py``); codes are [re | im]."""

    name = "complex"

    def energies(self, params, e1, r, e2):
        return sddmm.complex_energies(e1, r, e2)

    # ComplEx is bilinear too (``decoders.py:111-126``): energy(e1) = e1 . q
    # with q = [rr*e2r + ri*e2i | rr*e2i - ri*e2r], and energy(e2) = q' . e2
    # with q' = [e1r*rr - e1i*ri | e1i*rr + e1r*ri].
    def subject_factor(self, params, r, e2):
        rr, ri = sddmm.complex_parts(r)
        e2r, e2i = sddmm.complex_parts(e2)
        return torch.cat([rr * e2r + ri * e2i, rr * e2i - ri * e2r], dim=-1)

    def object_factor(self, params, e1, r):
        rr, ri = sddmm.complex_parts(r)
        e1r, e1i = sddmm.complex_parts(e1)
        return torch.cat([e1r * rr - e1i * ri, e1i * rr + e1r * ri], dim=-1)

    def all_subject_energies(self, params, all_codes, r, e2):
        return sddmm.complex_all_subjects(all_codes, r, e2)

    def all_object_energies(self, params, all_codes, e1, r):
        return sddmm.complex_all_objects(all_codes, e1, r)


class NonlinearTransform:
    """1-hidden-layer MLP decoder (``decoders.py:135-208``,
    ``decoders/nonlinear_transform.py``):

        energy = relu(e1 W_e1 + r W_r + e2 W_e2 + b_pre) W_transform + b_post

    Not bilinear in the codes, so it trains only through the tiled loss.
    All-entity scoring broadcasts the candidate term through the hidden
    layer, the correct form that the JAX package implements (the
    reference's falls back to the DistMult formula). JAX maps that over the
    rows one at a time; here it runs over blocks of rows whose [rows, V, D]
    hidden activations fit in ``score_budget_bytes``.
    """

    name = "nonlinear-transform"
    factorizable = False

    def __init__(self, dimension: int, embedding_width: int,
                 regularization_parameter: float,
                 score_budget_bytes: int = 1 << 30):
        self.dimension = dimension
        self.embedding_width = embedding_width
        self.regularization_parameter = regularization_parameter
        self.score_budget_bytes = score_budget_bytes

    def init(self, generator: torch.Generator) -> Dict:
        """The JAX package's shapes and standard deviations, drawn from
        ``generator``."""
        std_in = math.sqrt(1.0 / (self.embedding_width + self.dimension))
        std_out = math.sqrt(1.0 / (self.dimension + 1))
        shape = (self.embedding_width, self.dimension)
        device = generator.device
        return {
            "W_e1": init.normal(generator, shape, std_in),
            "W_r": init.normal(generator, shape, std_in),
            "W_e2": init.normal(generator, shape, std_in),
            "b_pre": init.zeros((self.dimension,), device),
            "W_transform": init.normal(generator, (self.dimension, 1),
                                       std_out),
            "b_post": init.zeros((1,), device),
        }

    def energies(self, params, e1, r, e2):
        """The codes in the weights' dtype: on a bf16 stream JAX's dot of
        bf16 codes and f32 weights promotes to f32, and torch multiplies
        no mixed dtypes, so they are upcast (exactly)."""
        exact_float32()
        dt = params["W_e1"].dtype
        hidden = (e1.to(dt) @ params["W_e1"] + r.to(dt) @ params["W_r"]
                  + e2.to(dt) @ params["W_e2"] + params["b_pre"])
        return (torch.relu(hidden) @ params["W_transform"]
                + params["b_post"]).squeeze(-1)

    def all_subject_energies(self, params, all_codes, r, e2):
        exact_float32()
        fixed = r @ params["W_r"] + e2 @ params["W_e2"] + params["b_pre"]
        return self._broadcast_score(params, fixed,
                                     all_codes @ params["W_e1"])

    def all_object_energies(self, params, all_codes, e1, r):
        exact_float32()
        fixed = e1 @ params["W_e1"] + r @ params["W_r"] + params["b_pre"]
        return self._broadcast_score(params, fixed,
                                     all_codes @ params["W_e2"])

    def _broadcast_score(self, params, fixed, cand):
        """[N, V] = relu(fixed[n] + cand[v]) . W_transform + b_post, over
        blocks of rows of fixed [N, D] against cand [V, D]."""
        n_cand, dim = cand.shape
        rows = max(1, self.score_budget_bytes // (4 * n_cand * dim))
        w = params["W_transform"][:, 0]
        # One [rows, V, D] temporary a block: the ReLU runs in place.
        out = [(fixed[i:i + rows, None, :] + cand).relu_() @ w
               for i in range(0, fixed.shape[0], rows)]
        return torch.cat(out) + params["b_post"]

    regularization = BilinearDiag.regularization


class ConvE:
    """The ConvE scorer of the official ``CompGCN_ConvE`` (Dettmers et al.,
    arXiv:1707.01476): a query's subject and relation codes [n, d]
    interleaved into one [2 k_w, k_h] image, BatchNorm, ``n_filters``
    filters of k x k (no padding, no bias), BatchNorm,
    ReLU, dropout, a fully connected map to d, dropout, BatchNorm, ReLU;
    then its product with every entity's code plus a bias per entity: the
    energies [n, V] of all candidate objects. ``keep_masks`` (training):
    the keep-masks of the filters' output [n, F, H, W] and of the map's
    output [n, d]. The convolution runs on cuDNN with TF32 off and
    deterministic algorithms (``exact_float32``)."""

    name = "conve"
    factorizable = False

    def __init__(self, config: CompGCNConfig, n_entities: int):
        self.c = config
        self.n_entities = n_entities
        self.dimension = config.k_w * config.k_h

    def init(self, generator: torch.Generator) -> Dict:
        """``torch.nn``'s default initialisation of the layers, drawn from
        ``generator``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the filters
        and the map; BatchNorm's scales 1 and shifts 0; the entity bias 0."""
        c, dev = self.c, generator.device
        k, d = c.kernel_size, self.dimension

        def uniform(shape, fan_in):
            bound = 1.0 / math.sqrt(fan_in)
            return (2 * torch.rand(shape, generator=generator, device=dev)
                    - 1) * bound
        params = {"conv_W": uniform((c.n_filters, 1, k, k), k * k),
                  "fc_W": uniform((c.flat_size, d), c.flat_size),
                  "fc_b": uniform((d,), c.flat_size),
                  "entity_bias": init.zeros((self.n_entities,), dev)}
        for name, n in (("bn0", 1), ("bn1", c.n_filters), ("bn2", d)):
            params[f"{name}_weight"] = torch.ones(n, device=dev)
            params[f"{name}_bias"] = init.zeros((n,), dev)
        return params

    def init_stats(self, device) -> Dict:
        """The three BatchNorms' running statistics."""
        return {"bn0": init_batch_stats(1, device),
                "bn1": init_batch_stats(self.c.n_filters, device),
                "bn2": init_batch_stats(self.dimension, device)}

    def hidden(self, params, stats, e1: torch.Tensor, r: torch.Tensor, *,
               training: bool,
               keep_masks: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        """[n, d]: the query's code before the product with the entities."""
        c = self.c
        n = e1.shape[0]
        image = torch.stack([e1, r], dim=2).reshape(n, 1, 2 * c.k_w, c.k_h)
        x = batch_norm(image, params["bn0_weight"], params["bn0_bias"],
                       stats["bn0"], training)
        exact_float32()
        x = F.conv2d(x, params["conv_W"])
        x = torch.relu(batch_norm(x, params["bn1_weight"],
                                  params["bn1_bias"], stats["bn1"],
                                  training))
        if keep_masks is not None:
            x = dropped(x, keep_masks[0], c.feature_dropout)
        x = x.reshape(n, c.flat_size) @ params["fc_W"] + params["fc_b"]
        if keep_masks is not None:
            x = dropped(x, keep_masks[1], c.decoder_dropout)
        return torch.relu(batch_norm(x, params["bn2_weight"],
                                     params["bn2_bias"], stats["bn2"],
                                     training))

    def all_object_energies(self, params, all_codes: torch.Tensor,
                            hidden: torch.Tensor) -> torch.Tensor:
        """[n, V] energies of every entity as the object."""
        exact_float32()
        return hidden @ all_codes.T + params["entity_bias"]


def build_decoder(name: str, code_dimension: int,
                  regularization_parameter: float,
                  decoder_dimension: int = 500, embedding_width: int = 500):
    """Decoder factory (``decoders.py:211-224``)."""
    if name == "bilinear-diag":
        return BilinearDiag(code_dimension, regularization_parameter)
    if name == "complex":
        return Complex(code_dimension, regularization_parameter)
    if name == "nonlinear-transform":
        return NonlinearTransform(decoder_dimension, embedding_width,
                                  regularization_parameter)
    raise ValueError(f"unknown decoder {name!r}")
