"""The R-GCN layer variants that sum per-edge messages with
staircase_aggregate (TPU kernel 3) through the port on the CPU against the
JAX package: basis_plus_diag (x[src] * D[r] on top of the basis message),
basis_times_diag (sigmoid-scaled [R, B, d] coefficients, on dense and
one-hot input) and only_bias (b[r] alone, no self-loop), each layer's
output and gradient against JAX's ``apply_gcn_layer`` (the JAX side runs
kernel 3 in Pallas interpret mode), in test mode and in train mode with
JAX's keep-mask; the 'none' and 'local' edge weights against JAX's
``degree_normalization``; and, through the model harness of
tests/test_torch_onehot_model.py, the models built on basis_plus_diag and
basis_times_diag (encode, scores, ranks, one step's gradients, Adam
steps, the train CLI)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationprediction_tpu import graph as jax_graph
from relationprediction_tpu.models import encoders as jax_enc
from relationprediction_torch import graph as torch_graph
from relationprediction_torch.models import encoders as torch_enc
from relationprediction_torch.params import params_from_jax

from test_torch_onehot_model import (CPU, case, check_adam_steps,
                                     check_checkpoint_and_evaluate_cli,
                                     check_encode_and_scores,
                                     check_loss_and_grads, check_ranks,
                                     check_train_cli, check_trees)

V, R, E, D, B = 40, 5, 200, 12, 3
KEEP = 0.8
VARIANTS = ["basis_plus_diag", "basis_times_diag", "only_bias"]
# values rtol / atol 1e-5 (kernel 3 is exact up to its sum order); the
# gradients 2e-4 (torch's and XLA's CPU sums in other orders)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def triples(seed=0, n_edges=E):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, V, n_edges), rng.integers(0, R, n_edges),
                     rng.integers(0, V, n_edges)], 1).astype(np.int32)


def graphs():
    t = triples()
    return (jax_graph.build_graph_batch(t, V, R, pad_to=256, staircase=True),
            torch_graph.build_graph_batch(t, V, R))


def layer_case(variant, onehot, deterministic):
    """JAX's layer output and its gradient (of sum(out * G), with respect
    to the params and the features) against the port's."""
    jg, tg = graphs()
    jparams = jax_enc.init_gcn_layer(
        jax.random.PRNGKey(0), variant, n_relations=R, d_in=D, d_out=D,
        n_bases=B, onehot_dim=V if onehot else None)
    rng = np.random.default_rng(1)
    x = None if onehot else rng.normal(size=(V, D)).astype(np.float32)
    cot = rng.normal(size=(V, D)).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def jlayer(p, feats):
        return jax_enc.apply_gcn_layer(
            p, variant, jg, feats, n_bases=B, use_nonlinearity=True,
            dropout_keep=KEEP, deterministic=deterministic, rng=key,
            n_vertices=V)
    if onehot:
        want, vjp = jax.vjp(lambda p: jlayer(p, None), jparams)
        jgrads, jdx = vjp(jnp.asarray(cot))[0], None
    else:
        want, vjp = jax.vjp(jlayer, jparams, jnp.asarray(x))
        jgrads, jdx = vjp(jnp.asarray(cot))

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    for p in params.values():
        p.requires_grad_(True)
    feats = None if onehot else torch.from_numpy(x).requires_grad_(True)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, KEEP,
                                                          (V, D))))
    got = torch_enc.apply_gcn_layer(
        params, variant, tg, feats, fused=False, use_nonlinearity=True,
        dropout_keep=KEEP, deterministic=deterministic, generator=None,
        n_vertices=V, keep_mask=keep)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    for k in sorted(params):
        g = params[k].grad
        g = torch.zeros_like(params[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   err_msg=k, **GRAD_TOL)
    if not onehot:
        # only_bias never reads its input: no gradient (zero in JAX)
        dx = torch.zeros_like(feats) if feats.grad is None else feats.grad
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **GRAD_TOL)
    return params


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_dense_layer_and_gradient_match_jax(variant, deterministic):
    params = layer_case(variant, False, deterministic)
    # the bias: added by the diag variants, absent from only_bias's tree
    if variant == "only_bias":
        assert sorted(params) == ["b_backward", "b_forward"]
    else:
        assert params["b"].grad.abs().max() > 0


@pytest.mark.parametrize("deterministic", [True, False])
def test_one_hot_times_diag_layer_matches_jax(deterministic):
    """basis_times_diag on one-hot input: the projection is W itself."""
    params = layer_case("basis_times_diag", True, deterministic)
    assert tuple(params["W_forward"].shape) == (V, B, D)
    assert tuple(params["C_forward"].shape) == (R, B, D)


def test_one_hot_only_bias_layer_matches_jax():
    layer_case("only_bias", True, False)


def test_plus_diag_raises_on_one_hot_input():
    """x[src] * D[r] needs dense features, in JAX (``proj_features``) and
    in the port."""
    jg, tg = graphs()
    jparams = jax_enc.init_gcn_layer(
        jax.random.PRNGKey(0), "basis_plus_diag", n_relations=R, d_in=D,
        d_out=D, n_bases=B, onehot_dim=V)
    with pytest.raises(ValueError):
        jax_enc.apply_gcn_layer(jparams, "basis_plus_diag", jg, None,
                                n_bases=B, use_nonlinearity=False,
                                dropout_keep=KEEP, deterministic=True,
                                rng=None, n_vertices=V)
    params = torch_enc.init_gcn_layer(
        torch.Generator().manual_seed(0), "basis_plus_diag", n_relations=R,
        d_in=D, d_out=D, n_bases=B, onehot_dim=V)
    assert tuple(params["W_forward"].shape) == (V, B, D)
    with pytest.raises(ValueError, match="dense input"):
        torch_enc.apply_gcn_layer(params, "basis_plus_diag", tg, None,
                                  fused=False, use_nonlinearity=False,
                                  dropout_keep=KEEP, deterministic=True,
                                  generator=None, n_vertices=V)


@pytest.mark.parametrize("variant", VARIANTS + ["basis_stored"])
def test_init_gives_jax_shapes(variant):
    want = jax_enc.init_gcn_layer(jax.random.PRNGKey(0), variant,
                                  n_relations=R, d_in=D, d_out=D, n_bases=B)
    got = torch_enc.init_gcn_layer(torch.Generator().manual_seed(0),
                                   variant, n_relations=R, d_in=D, d_out=D,
                                   n_bases=B)
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("normalization", ["global", "local", "none"])
def test_edge_weights_match_degree_normalization(normalization, direction):
    """Each CSR entry's weight is JAX's weight of its input edge
    (``fwd_order`` / ``bwd_order``), and a twin carries its direction's
    weights in the opposite direction's order. JAX computes them on the
    device from a graph without host weights."""
    t = triples(seed=2, n_edges=300)
    jg = jax_graph.build_graph_batch(t, V, R, pad_to=384, normalization=None)
    want = np.asarray(jax_graph.degree_normalization(jg, direction,
                                                     normalization))
    assert not want[len(t):].any()  # padding weighs nothing
    g = torch_graph.build_graph_batch(t, V, R, normalization=normalization)
    layout, order, twin, other = (
        (g.fwd, g.fwd_order, g.fwd_twin, g.bwd_order)
        if direction == "forward" else
        (g.bwd, g.bwd_order, g.bwd_twin, g.fwd_order))
    np.testing.assert_allclose(layout.w.numpy(), want[order.numpy()],
                               rtol=1e-7)
    np.testing.assert_allclose(twin.w.numpy(), want[other.numpy()],
                               rtol=1e-7)
    if normalization == "local":
        # a (target, relation) pair's weights sum to 1 per direction
        target = t[:, 2] if direction == "forward" else t[:, 0]
        pairs = target * R + t[:, 1]
        sums = np.bincount(pairs, weights=want[:len(t)])
        np.testing.assert_allclose(sums[np.unique(pairs)], 1.0, rtol=1e-6)


def test_graph_orders_and_their_copies():
    """fwd_order / bwd_order give each CSR entry's input edge, and to(),
    pin-free copies and tensors() carry them."""
    t = triples(seed=3)
    g = torch_graph.build_graph_batch(t, V, R)
    for layout, order, target in ((g.fwd, g.fwd_order, t[:, 2]),
                                  (g.bwd, g.bwd_order, t[:, 0])):
        assert order.dtype == torch.int64
        assert sorted(order.tolist()) == list(range(len(t)))
        np.testing.assert_array_equal(layout.rel.numpy(),
                                      t[order.numpy(), 1])
        rows = np.repeat(np.arange(V), np.diff(layout.row_ptr.numpy()))
        np.testing.assert_array_equal(rows, target[order.numpy()])
    h = g.to("cpu")
    assert torch.equal(h.fwd_order, g.fwd_order)
    assert any(x is g.bwd_order for x in g.tensors())


# ---------------------------------------------------------------------------
# The models on these layers (gcn_basis.exp with AddDiagonal=Yes or
# DiagonalCoefficients=Yes; the latter also without its input transform)
# ---------------------------------------------------------------------------

MODEL_KINDS = ["plus_diag", "times_diag", "times_diag_onehot"]


@pytest.mark.parametrize("kind", MODEL_KINDS)
def test_encode_and_scores_match_jax(kind):
    check_encode_and_scores(kind, "synthetic")


@pytest.mark.parametrize("kind", MODEL_KINDS)
def test_scorer_ranks_equal_jax(kind):
    check_ranks(kind, "toy")


@pytest.mark.parametrize("kind", MODEL_KINDS)
def test_loss_and_every_gradient_leaf_match_jax(kind):
    grads = check_loss_and_grads(kind, "synthetic")
    for layer in grads["gcn_layers"]:
        # every parameter is used, the bias included
        for key, g in layer.items():
            assert g.abs().max() > 0, key


@pytest.mark.parametrize("kind", MODEL_KINDS)
def test_params_after_optimizer_steps_match_optax(kind):
    # The one-hot layer's [V, B, d] bases get their gradient through
    # sigmoid(C) < 1 from the few edges of each row: 1.15 % of all entries
    # fall under 1e-6 at some step; those are held within lr a step, the
    # others within 1e-5.
    check_adam_steps(kind, "synthetic",
                     max_near_zero=0.02 if kind == "times_diag_onehot"
                     else 0.01)


@pytest.mark.parametrize("kind", MODEL_KINDS)
def test_param_tree_matches_jax(kind):
    check_trees(kind)
    _, _, (_, model, _, _) = case(kind, "synthetic")
    assert model.variant == {"plus_diag": "basis_plus_diag"}.get(
        kind, "basis_times_diag")
    assert not model.preferred_staircase2


def test_checkpoint_and_evaluate_cli_carry_the_tree(tmp_path, capsys):
    check_checkpoint_and_evaluate_cli(tmp_path, capsys, "plus_diag")


def test_train_cli_runs_times_diag_on_cpu(tmp_path):
    check_train_cli(tmp_path, "times_diag")
