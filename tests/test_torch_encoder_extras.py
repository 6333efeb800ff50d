"""The encoder extras through the port on the CPU against the JAX package:
highway gates (with a None gate on a one-hot first layer), residual
connections with the output transform, random and partially random input.
Encode and all-entity scores, ranks, the loss and every gradient leaf of
one step and the params after 1 and 3 Adam steps, each with JAX's own
draws (keep-masks, random input at fold_in 23, the dropover choice at 29);
the param tree through params_from_jax, checkpoints both ways and
opt_state_from_jax; the train CLI; and the bf16 stream precision's dtype
and cast against the JAX package's. Block layers on dense input
take TPU kernel 1 (block_direction), basis layers on one-hot input kernel
3 (staircase_aggregate)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_tpu.training import checkpoint as jax_ckpt
from relationprediction_tpu.training.optimizers import (
    build_optimizer as jax_optimizer)
from relationprediction_torch import config as torch_config
from relationprediction_torch.models.build import build_model
from relationprediction_torch.params import (params_from_jax,
                                             params_to_numpy, tree_leaves)
from relationprediction_torch.training import checkpoint as torch_ckpt
from relationprediction_torch.training.optimizers import (build_optimizer,
                                                          opt_state_from_jax)

from test_torch_onehot_model import (CPU, case, check_adam_steps,
                                     check_checkpoint_and_evaluate_cli,
                                     check_encode_and_scores,
                                     check_evaluate_cli_runs,
                                     check_loss_and_grads, check_ranks,
                                     check_train_cli, check_trees,
                                     settings_path, small)

KINDS = ["highway", "highway_onehot", "residual_out", "random", "partial"]


@pytest.mark.parametrize("kind", KINDS)
def test_encode_and_scores_match_jax(kind):
    check_encode_and_scores(kind, "synthetic")


@pytest.mark.parametrize("kind", KINDS)
def test_scorer_ranks_equal_jax(kind):
    check_ranks(kind, "toy")


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_every_gradient_leaf_match_jax(kind):
    grads = check_loss_and_grads(kind, "synthetic")
    if "highways" in grads:
        for gate in grads["highways"]:
            if gate is not None:
                assert gate["W"].abs().max() > 0 and gate["b"].abs().max() > 0
    if kind == "residual_out":
        assert grads["output_transform"]["W"].abs().max() > 0
    if kind == "partial":
        # the dropover keeps some of the affine map, so it learns
        assert grads["input_transform"]["W"].abs().max() > 0


@pytest.mark.parametrize("kind", KINDS)
def test_params_after_optimizer_steps_match_optax(kind):
    check_adam_steps(kind, "synthetic")


@pytest.mark.parametrize("kind", KINDS)
def test_param_tree_matches_jax(kind):
    """The tree leaf for leaf and Adam's state; the stages each
    configuration adds."""
    fresh = check_trees(kind)
    ds, _, (tcfg, model, params, _) = case(kind, "synthetic")
    d, code = tcfg.encoder.internal_dimension, tcfg.encoder.code_dimension
    want = {"highway": ["input_transform", "highways"],
            "highway_onehot": ["highways"],
            "residual_out": ["input_transform", "output_transform"],
            "random": [], "partial": ["input_transform"]}[kind]
    assert sorted(params) == sorted(
        ["decoder", "gcn_layers", "relation_embedding"] + want)
    if "highways" in params:
        gates = params["highways"]
        # no gate where the layer's input is one-hot
        assert (gates[0] is None) == (kind == "highway_onehot")
        assert tuple(gates[1]["W"].shape) == (d, d)
        assert torch.equal(fresh["highways"][1]["b"], torch.ones(d))
    if kind == "residual_out":
        assert tuple(params["output_transform"]["W"].shape) == (d, code)
    assert model.first_layer_onehot == (kind == "highway_onehot")


@pytest.mark.parametrize("kind", ["highway_onehot", "residual_out"])
def test_checkpoints_both_ways_and_opt_state(tmp_path, kind):
    """A JAX checkpoint (a None gate in its params and in optax's state)
    restored by the port: params leaf for leaf, Adam's state through
    opt_state_from_jax; and a port checkpoint read by the JAX package's
    restore into JAX's tree."""
    ds, (jcfg, _, jparams, _), (tcfg, _, _, _) = case(kind, "synthetic")
    jopt = jax_optimizer(jcfg.optimizer)
    jstate = jopt.init(jparams)
    # one update so the moments are not all zero
    grads = jax.tree_util.tree_map(lambda a: a * 0.5 + 1.0, jparams)
    _, jstate = jopt.update(grads, jstate, jparams)
    jax_ckpt.save(str(tmp_path / "j"), params=jparams, opt_state=jstate,
                  step=3, rng_key=jax.random.PRNGKey(2))
    state = torch_ckpt.restore_latest(str(tmp_path / "j"))
    params = params_from_jax(state["params"], CPU)
    if kind == "highway_onehot":
        assert params["highways"][0] is None
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(params_to_numpy(params))):
        np.testing.assert_array_equal(np.asarray(a), b)
    opt = opt_state_from_jax(state["opt_state"], "Adam")
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    assert int(opt["count"]) == int(adam.count) == 1
    for key in ("mu", "nu"):
        want = jax.tree_util.tree_leaves(getattr(adam, key))
        got = tree_leaves(opt[key])
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if kind == "highway_onehot":
        assert opt["mu"]["highways"][0] is None
    # the other way: the port's checkpoint in JAX's restore
    port_state = build_optimizer(tcfg.optimizer).init(params)
    torch_ckpt.save(str(tmp_path / "t"), params=params_to_numpy(params),
                    opt_state=params_to_numpy(port_state), step=4,
                    rng_key=np.zeros(2, np.uint32))
    back = jax_ckpt.restore_latest(str(tmp_path / "t"))
    assert jax.tree_util.tree_structure(back["params"]) \
        == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(back["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("kind", ["highway_onehot", "residual_out"])
def test_checkpoint_and_evaluate_cli_carry_the_tree(tmp_path, capsys,
                                                    kind):
    check_checkpoint_and_evaluate_cli(tmp_path, capsys, kind)


@pytest.mark.parametrize("kind", ["random", "partial"])
def test_evaluate_cli_runs_random_input(tmp_path, capsys, kind):
    check_evaluate_cli_runs(tmp_path, capsys, kind)


@pytest.mark.parametrize("kind", ["highway_onehot", "random"])
def test_train_cli_runs_the_extras_on_cpu(tmp_path, kind):
    check_train_cli(tmp_path, kind)


def test_bf16_stream_precision_raises():
    """DecoderConfig.stream_precision: the port's stream dtype is the JAX
    package's ``_dec_dtype`` for every spelling (``build.py:117-118``),
    and its stream cast gives ``_stream_cast``'s bits: entity and relation
    codes rounded to bf16, the variational statistics untouched. (Until
    bf16 streams were ported this config raised, after building silently
    in f32 before that.)"""
    from relationprediction_tpu.models.build import (
        EncodeResult as JaxEncodeResult)
    from relationprediction_torch.models.build import EncodeResult
    ds, (jcfg, _, _, _), (tcfg, _, _, _) = case("highway", "synthetic")
    rng = np.random.default_rng(0)
    codes = rng.standard_normal((ds.n_entities, 20)).astype(np.float32)
    rel = rng.standard_normal((ds.n_relations, 20)).astype(np.float32)
    mu = rng.standard_normal((ds.n_entities, 20)).astype(np.float32)
    for stream in ("float32", "bfloat16", "bf16"):
        jmodel = jax_build(dataclasses.replace(
            jcfg, decoder=dataclasses.replace(jcfg.decoder,
                                              stream_precision=stream)))
        model = build_model(dataclasses.replace(
            tcfg, decoder=dataclasses.replace(tcfg.decoder,
                                              stream_precision=stream)), CPU)
        if jmodel._dec_dtype is None:
            assert model.stream_dtype is None
        else:
            assert np.dtype(jmodel._dec_dtype).name == "bfloat16"
            assert model.stream_dtype == torch.bfloat16
        want = jmodel._stream_cast(JaxEncodeResult(codes, rel, mu, mu))
        got = model.stream_cast(EncodeResult(
            *(torch.from_numpy(a) for a in (codes, rel, mu, mu))))
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert str(g.dtype).endswith(w.dtype.name)
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy() if g.dtype == torch.bfloat16
                else g.numpy(),
                w.view(np.int16) if w.dtype.name == "bfloat16" else w)
    for cfg in (small(torch_config.load(settings_path("onehot")), ds,
                      "onehot"), tcfg):
        build_model(cfg, CPU)  # float32 streams build
