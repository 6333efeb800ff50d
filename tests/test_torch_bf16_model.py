"""bf16 message and stream precision through whole models, the port's
plain path on the CPU against the JAX package's bf16 on the same params,
draws and keep-masks: gcn_block (TPU kernel 1), gcn_basis (kernel 2), the
one-hot first layer, gcn_diag and basis_plus_diag (kernel 3) and DistMult
(streams only; on a 1,100-entity graph also through the fused energy
backwards). Test-mode codes, then each of the four training losses (tiled,
factored binomial, split, shared pool) and every gradient leaf.

The two packages round at different places (tests/test_torch_bf16_ops.py),
so each bf16 result is held to its f32 counterpart in the JAX package, in
relative L2 norm (a loss: relative difference): the port's distance at
most the larger of 1.5 x JAX's own bf16 distance and ``FLOOR``, and the
port within ``NEAR`` of JAX's bf16. The codes average over many rounding
errors, so their floor is f32 noise; a loss is one number and a gradient
leaf moves with the ReLU gates that a bf16 rounding flips near 0, so the
bf16 distance of either is the luck of a few terms, and their floors are
JAX's own 1e-2 rule for losses (tests/test_bf16_streams.py) and 2e-2 for
leaves (a wrong formula moves a leaf by its own size). The configurations
that JAX runs in f32 whatever the precision (the stored variant, 'local'
and 'none' graphs) give the f32 bits; a 15-step fit on data/Toy lowers
the loss. This file holds the codes of every configuration and the losses
of gcn_block, gcn_basis, the one-hot layer and DistMult;
test_torch_bf16_model_kernel3.py the losses of the kernel 3 configurations
(gcn_diag, basis_plus_diag, DistMult on the fused energies) and the rest,
on this file's helpers."""
import dataclasses
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import synthetic as jax_synthetic
from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_tpu.training.device_sampling import (
    device_negative_parts, device_negative_sample)
from relationprediction_torch import config as torch_config
from relationprediction_torch.models.build import build_model
from relationprediction_torch.params import params_from_jax, tree_leaves
from relationprediction_torch.training.engine import _value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
BF16 = torch.bfloat16
# (settings file, encoder changes, dataset): cut to d=20 by ``small``.
KINDS = {
    "block": ("gcn_block", {}, "synthetic"),
    "basis": ("gcn_basis", {}, "synthetic"),
    "onehot": ("gcn_basis", dict(use_input_transform=False), "synthetic"),
    "diag": ("gcn_basis", dict(name="gcn_diag"), "synthetic"),
    "plus_diag": ("gcn_basis", dict(add_diagonal=True), "synthetic"),
    "distmult": ("distmult", {}, "synthetic"),
    "distmult_fused": ("distmult", {}, "wide"),
}
LOSSES = ["tiled", "factored", "split", "shared"]
# Positives of a loss's batch: full (no padding rows), so JAX's split and
# shared CE masks are right on it; 2,000 on the 1,100-entity graph, where
# n * k reaches the fused energies' 8,192 in every loss.
POSITIVES = {"synthetic": 600, "wide": 2000}
FLOOR = {"codes": 1e-6, "loss": 1e-2, "grad": 2e-2}
NEAR = {"codes": 1e-2, "loss": 2e-3, "grad": 2e-2}


@functools.lru_cache(maxsize=None)
def dataset(name):
    if name == "synthetic":
        return jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)
    return jax_synthetic.generate(1100, 11, 3000, 50, 50, seed=1)


def small(cfg, ds, changes, bf16):
    """The settings with the encoder ``changes`` at d=20 (4 blocks of 5, 3
    bases), both precisions bf16 where ``bf16``."""
    precision = "bfloat16" if bf16 else "float32"
    enc = {"code_dimension": 20, "internal_dimension": 20,
           "n_bases": 4 if cfg.encoder.gcn_variant == "block" else 3,
           "message_precision": precision, **changes}
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, **enc),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20,
                                    stream_precision=precision),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


@functools.lru_cache(maxsize=None)
def case(kind, bf16):
    """JAX's model, params and serving graph (kernel 3's layouts where the
    model has no fused ones), and the port's, at one precision; the
    params are JAX's f32 draw either way."""
    settings, changes, data = KINDS[kind]
    ds = dataset(data)
    path = str(ROOT / "settings" / f"{settings}.exp")
    jcfg = small(jax_config.load(path), ds, changes, bf16)
    tcfg = small(torch_config.load(path), ds, changes, bf16)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build(jcfg)
    jparams = jax_build(small(jax_config.load(path), ds, changes, False)) \
        .init_params(jax.random.PRNGKey(0))
    model = build_model(tcfg, CPU)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    if not model.needs_graph():
        return ds, (jmodel, jparams, None), (model, params, None)
    # JAX's own default gives gcn_diag and basis_plus_diag (from
    # gcn_basis.exp) the fused layouts, which they cannot use, and
    # aggregates them in f32; the layouts of the port's route are asked
    # for: the fused ones, or kernel 3's.
    pad = -(-jmodel.graph_pad_bound(len(ds.train)) // 128) * 128
    fused = model.preferred_staircase2
    jgraph = jmodel.make_graph(ds.train, pad_to=pad, staircase=not fused,
                               staircase2=fused)
    return ds, (jmodel, jparams, jgraph), \
        (model, params, model.make_graph(ds.train))


def rel_l2(a, b, scale=None) -> float:
    """|a - b| / |scale| (scale b by default) in the L2 norm."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    norm = np.linalg.norm(b if scale is None else scale)
    return float(np.linalg.norm(a - b) / (norm if norm else 1.0))


def assert_bar(port, jax16, jax32, what, kind):
    """port: the port's bf16 result; jax16 / jax32: JAX's bf16 and f32."""
    port = np.asarray(port, np.float64)
    assert np.isfinite(port).all(), what
    port_err, jax_err = rel_l2(port, jax32), rel_l2(jax16, jax32)
    assert port_err <= max(1.5 * jax_err, FLOOR[kind]), \
        (what, port_err, jax_err)
    near = rel_l2(port, jax16, jax32)
    assert near <= NEAR[kind], (what, near)


@pytest.mark.parametrize("kind", list(KINDS))
def test_encode_codes_match_jax_bf16(kind):
    """Test-mode codes (bf16 messages; scoring stays f32)."""
    _, (jmodel16, jparams, jgraph), (model, params, graph) = case(kind, True)
    jmodel32 = case(kind, False)[1][0]
    want16 = jmodel16.encode(jparams, jgraph, deterministic=True)
    want32 = jmodel32.encode(jparams, jgraph, deterministic=True)
    got = model.encode(params, graph, deterministic=True)
    assert got.entity_codes.dtype == torch.float32
    assert_bar(got.entity_codes.numpy(), want16.entity_codes,
               want32.entity_codes, "codes", "codes")
    if kind not in ("distmult", "distmult_fused"):
        # bf16 messages move the codes, within bf16's rounding
        assert 1e-5 < rel_l2(want16.entity_codes, want32.entity_codes) < 2e-2


def draws(kind, loss):
    """The positives, JAX's key, the loss's negatives (numpy) and the
    keep-masks JAX's encoder draws under the key."""
    ds, (jmodel, _, _), (model, _, _) = case(kind, True)
    cfg = jmodel.config
    n = POSITIVES[KINDS[kind][2]]
    positives = np.asarray(ds.train[:n], np.int32)
    mask = np.ones(n, np.float32)
    key = jax.random.PRNGKey(7)
    sub = jax.random.fold_in(key, 777)
    rate, v = cfg.training.negative_sample_rate, cfg.entity_count
    rng = np.random.default_rng(5)
    if loss == "tiled":
        neg = tuple(np.array(a) for a in device_negative_sample(
            positives, mask, rate, v, sub))
    elif loss == "factored":
        neg = tuple(np.array(a) for a in device_negative_parts(
            positives, rate, v, sub))
    elif loss == "split":
        neg = (rng.integers(0, v, (n, rate // 2)).astype(np.int32),
               rng.integers(0, v, (n, rate - rate // 2)).astype(np.int32))
    else:
        neg = (rng.integers(0, v, 24).astype(np.int32),)
    e = cfg.encoder
    masks = [np.array(jax.random.bernoulli(
        jax.random.fold_in(key, 100 + layer), e.dropout_keep_probability,
        (v, e.internal_dimension)))
        for layer in range(e.n_layers)] if model.is_gcn else []
    return positives, mask, key, neg, masks


def jax_loss(jmodel, graph, loss, positives, mask, key, neg):
    if loss == "tiled":
        return lambda p: jmodel.loss(p, graph, *neg, rng=key,
                                     deterministic=False)
    if loss == "factored":
        return lambda p: jmodel.loss_binomial_factored(
            p, graph, positives, mask, *neg, rng=key, deterministic=False)
    if loss == "split":
        return lambda p: jmodel.loss_structured(
            p, graph, positives, mask, *neg, rng=key, deterministic=False)
    return lambda p: jmodel.loss_shared_negatives(
        p, graph, positives, mask, *neg, rng=key, deterministic=False)


def port_loss(model, params, graph, loss, positives, mask, neg, masks):
    masks = [torch.from_numpy(m) for m in masks]
    t = [torch.from_numpy(a) for a in (positives, mask) + neg]
    if loss == "tiled":
        fn = functools.partial(model.loss, params, graph, *t[2:])
    elif loss == "factored":
        fn = functools.partial(model.loss_binomial_factored, params, graph,
                               *t)
    elif loss == "split":
        fn = functools.partial(model.loss_structured, params, graph, *t)
    else:
        fn = functools.partial(model.loss_shared_negatives, params, graph,
                               *t)
    return _value_and_grad(functools.partial(fn, keep_masks=masks), params)


@functools.lru_cache(maxsize=None)
def losses(kind, loss):
    """(JAX bf16, JAX f32, port bf16, port f32) as (loss, leaves)."""
    positives, mask, key, neg, masks = draws(kind, loss)
    out = []
    for bf16 in (True, False):
        _, (jmodel, jparams, jgraph), _ = case(kind, bf16)
        value, grads = jax.value_and_grad(jax_loss(
            jmodel, jgraph, loss, positives, mask, key, neg))(jparams)
        out.append((float(value), [np.asarray(g) for g in
                                   jax.tree_util.tree_leaves(grads)]))
    for bf16 in (True, False):
        _, _, (model, params, graph) = case(kind, bf16)
        value, grads = port_loss(model, params, graph, loss, positives,
                                 mask, neg, masks)
        out.append((value.item(), [g.numpy() for g in tree_leaves(grads)]))
    return out


def check_losses_and_gradients(kind, loss):
    """The loss and every gradient leaf; the port's f32 step equals JAX's
    f32 step as the f32 tests hold it."""
    (j16, jg16), (j32, jg32), (p16, g16), (p32, g32) = losses(kind, loss)
    np.testing.assert_allclose(p32, j32, rtol=1e-5)
    assert_bar(p16, j16, j32, "loss", "loss")
    assert len(g16) == len(jg16) == len(jg32)
    for i, (g, w16, w32) in enumerate(zip(g16, jg16, jg32)):
        assert_bar(g, w16, w32, f"leaf {i} {g.shape}", "grad")


# The kinds whose losses this file checks (the others':
# test_torch_bf16_model_kernel3.py).
LOSS_KINDS = ["block", "basis", "onehot", "distmult"]


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kind", LOSS_KINDS)
def test_losses_and_gradients_match_jax_bf16(kind, loss):
    check_losses_and_gradients(kind, loss)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kind", ["block", "basis", "distmult"])
def test_bf16_loss_tracks_f32(kind, loss):
    """The bf16 loss within 1e-2 relative of the f32 loss on the same
    draws (tests/test_bf16_streams.py's rule), and not equal to it: the
    bf16 path ran; every gradient finite."""
    _, _, (p16, g16), (p32, _) = losses(kind, loss)
    assert p16 == pytest.approx(p32, rel=1e-2)
    assert p16 != p32
    assert all(np.isfinite(g).all() for g in g16)
