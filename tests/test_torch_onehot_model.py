"""The one-hot-input R-GCN (settings/gcn_basis.exp with UseInputTransform=No)
through the port on the CPU against the JAX package: encode, all-entity
scores and exact ranks; loss and every gradient leaf for the same draws and
masks; params after 1 and 3 Adam steps; the param tree through
params_from_jax and a checkpoint; the train and evaluate CLIs.

Every layer of this model sums per-edge messages with staircase_aggregate
(TPU kernel 3): the JAX side runs that kernel in Pallas interpret mode.
The check functions here serve tests/test_torch_diag_model.py too."""
import dataclasses
import functools
import gc
import os
import weakref
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.data import synthetic as jax_synthetic
from relationprediction_tpu.evaluation import Scorer as JaxScorer
from relationprediction_tpu.models.build import JittedModelView
from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_tpu.training import checkpoint as jax_ckpt
from relationprediction_tpu.training.engine import (
    BatchPipeline as JaxBatchPipeline)
from relationprediction_tpu.training.optimizers import (
    build_optimizer as jax_optimizer)
from relationprediction_torch import config as torch_config
from relationprediction_torch import evaluate as torch_evaluate
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.models.build import ModelView, build_model
from relationprediction_torch.params import (params_from_jax,
                                             params_to_numpy, tree_leaves,
                                             tree_unflatten)
from relationprediction_torch.training import checkpoint as torch_ckpt
from relationprediction_torch.training.engine import (BatchPipeline,
                                                      loss_and_grads)
from relationprediction_torch.training.optimizers import build_optimizer

from test_torch_train_step import check_params_after_adam_steps, jax_draws

ROOT = pathlib.Path(__file__).resolve().parents[1]
SETTINGS = str(ROOT / "settings" / "gcn_basis.exp")
TOY = str(ROOT / "data" / "Toy")
CPU = torch.device("cpu")
CASES = ["toy", "synthetic"]
# Both configurations derive from gcn_basis.exp, as
# tests/test_model_variants.py derives them.
MODELS = {"onehot": dict(use_input_transform=False),
          "diag": dict(name="gcn_diag")}
# The .exp lines that give the same configurations.
EXP_LINES = {"onehot": ("UseInputTransform=Yes", "UseInputTransform=No"),
             "diag": ("Name=gcn_basis", "Name=gcn_diag")}
# Codes and scores: a dense basis layer multiplies per edge in JAX
# (basis_messages_chunked) and per vertex in the port, the same function
# rounded otherwise (as in tests/test_torch_basis_model.py); kernel 3 is
# exact up to its sum order.
TOL = dict(rtol=2e-4, atol=2e-4)


def small(cfg, ds, kind):
    """gcn_basis.exp as ``kind`` (MODELS), cut to d=20, B=3, 2 layers."""
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, code_dimension=20,
                                    internal_dimension=20, n_bases=3,
                                    **MODELS[kind]),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


def dataset(name):
    if name == "toy":
        return jax_dataset.load(TOY)
    return jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)


@functools.lru_cache(maxsize=None)
def case(kind, name):
    """JAX config, model, params and serving graph (with TPU kernel 3's
    layouts); the port's counterparts."""
    ds = dataset(name)
    jcfg = small(jax_config.load(SETTINGS), ds, kind)
    tcfg = small(torch_config.load(SETTINGS), ds, kind)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    # gcn_diag built from gcn_basis.exp would get the fused layouts by
    # default and aggregate in XLA; staircase=True asks for kernel 3's.
    jgraph = jmodel.make_graph(ds.train,
                               pad_to=-(-len(ds.train) // 128) * 128,
                               staircase=True)
    assert jgraph.sc_fwd is not None and jgraph.sc_bwd is not None
    model = build_model(tcfg, CPU)
    assert not model.preferred_staircase2
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    return ds, (jcfg, jmodel, jparams, jgraph), \
        (tcfg, model, params, model.make_graph(ds.train))


def check_encode_and_scores(kind, name):
    ds, (_, jmodel, jparams, jgraph), (_, model, params, graph) = \
        case(kind, name)
    want = jmodel.encode(jparams, jgraph, deterministic=True)
    got = model.encode(params, graph, deterministic=True)
    np.testing.assert_allclose(got.entity_codes.numpy(),
                               np.asarray(want.entity_codes), **TOL)
    for fn in ("score_all_subjects", "score_all_objects"):
        want = np.asarray(getattr(jmodel, fn)(jparams, jgraph, ds.test))
        got = getattr(model, fn)(params, graph, ds.test)
        assert got.shape == (len(ds.test), ds.n_entities)
        np.testing.assert_allclose(got.numpy(), want, err_msg=fn, **TOL)


def check_ranks(kind, name):
    ds, (_, jmodel, jparams, jgraph), (_, model, params, graph) = \
        case(kind, name)

    def summary(scorer, view, p, g):
        for t in (ds.train, ds.valid, ds.test):
            scorer.register_data(t)
        scorer.register_degrees(ds.train)
        scorer.register_model(view, p, g, n_entities=ds.n_entities)
        scorer.finalize_frequency_computation(ds.all_triples())
        return scorer.compute_scores(ds.test)

    want = summary(JaxScorer(), JittedModelView(jmodel), jparams, jgraph)
    got = summary(Scorer(), ModelView(model), params, graph)
    np.testing.assert_array_equal(got.raw_ranks, want.raw_ranks)
    np.testing.assert_array_equal(got.filtered_ranks, want.filtered_ranks)
    assert got.results == want.results


def pipelines(kind, name, seed=0):
    """JAX's batch pipeline (its default graph layouts) and the port's."""
    ds, (jcfg, jmodel, _, _), (tcfg, model, _, _) = case(kind, name)
    return (JaxBatchPipeline(jmodel, jcfg, ds, np.random.default_rng(seed),
                             device_negatives=True),
            BatchPipeline(model, tcfg, ds, np.random.default_rng(seed)))


def both_steps(kind, name, jparams, params, jbatch, batch, step):
    """(JAX loss, JAX grads, port loss, port grads) for one batch and one
    set of draws and keep-masks."""
    _, (jcfg, jmodel, _, _), (_, model, _, _) = case(kind, name)
    key, values, co, masks = jax_draws(jcfg, jmodel, jbatch.triples, step)

    def jloss(p):
        return jmodel.loss_binomial_factored(
            p, jbatch.graph, jbatch.triples, jbatch.mask, values, co,
            rng=key, deterministic=False)
    want, jgrads = jax.value_and_grad(jloss)(jparams)
    got, grads = loss_and_grads(model, params, batch,
                                torch.from_numpy(values),
                                torch.from_numpy(co),
                                [torch.from_numpy(m) for m in masks])
    return float(want), jgrads, float(got), grads


def check_loss_and_grads(kind, name):
    """The loss within 1e-5 relative, every gradient leaf within rtol
    2e-4, atol 1e-6 (the dense layer's other rounding, as in
    tests/test_torch_basis_model.py); returns the port's gradients."""
    _, (_, _, jparams, _), _ = case(kind, name)
    jpipe, tpipe = pipelines(kind, name)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    want, jgrads, got, grads = both_steps(kind, name, jparams, params,
                                          jpipe.next(), tpipe.next(), 0)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    for g, jg in zip(leaves, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=1e-6)
    return grads


def check_adam_steps(kind, name):
    _, (jcfg, _, jparams, _), (tcfg, _, _, _) = case(kind, name)
    jpipe, tpipe = pipelines(kind, name)
    check_params_after_adam_steps(jcfg, tcfg, jparams, jpipe, tpipe,
                                  functools.partial(both_steps, kind, name))


def check_trees(kind):
    """The param tree and Adam's state line up with JAX's leaf for leaf;
    init_params gives JAX's shapes from a torch.Generator."""
    _, (jcfg, _, jparams, _), (tcfg, model, params, _) = \
        case(kind, "synthetic")
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(params_to_numpy(params))
    assert len(flat_j) == len(flat_t) == len(tree_leaves(params))
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    fresh = model.init_params(torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  params_to_numpy(fresh)) == shapes
    jstate = jax_optimizer(jcfg.optimizer).init(jparams)
    state = build_optimizer(tcfg.optimizer).init(params)
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    for key in ("mu", "nu"):
        want = [np.asarray(a).shape
                for a in jax.tree_util.tree_leaves(getattr(adam, key))]
        assert [tuple(t.shape) for t in tree_leaves(state[key])] == want
    return fresh


def small_exp(tmp_path, kind):
    """gcn_basis.exp as ``kind`` at d=20, B=3, saving under tmp_path."""
    src = open(SETTINGS).read()
    for old, new in (EXP_LINES[kind],
                     ("CodeDimension=500", "CodeDimension=20"),
                     ("InternalEncoderDimension=500",
                      "InternalEncoderDimension=20"),
                     ("NumberOfBasisFunctions=5",
                      "NumberOfBasisFunctions=3"),
                     ("ExperimentName=models/BasisGCN",
                      f"ExperimentName={tmp_path / 'm'}")):
        assert old in src, old
        src = src.replace(old, new)
    path = tmp_path / f"{kind}.exp"
    path.write_text(src)
    return str(path)


def check_checkpoint_and_evaluate_cli(tmp_path, capsys, kind):
    """A JAX checkpoint of this model comes back through the port's
    restore and params_from_jax leaf for leaf, and the port's evaluate CLI
    prints the JAX scorer's metrics for it."""
    exp = small_exp(tmp_path, kind)
    ds = jax_dataset.load(TOY)
    cfg = jax_config.load(exp).with_counts(ds.n_entities, ds.n_relations,
                                           len(ds.train))
    assert dataclasses.asdict(cfg.encoder) == dataclasses.asdict(
        small(jax_config.load(SETTINGS), ds, kind).encoder)
    model = jax_build(cfg)
    params = model.init_params(jax.random.PRNGKey(1))
    jax_ckpt.save(str(tmp_path / "m"), params=params,
                  opt_state=jax_optimizer(cfg.optimizer).init(params),
                  step=5, rng_key=jax.random.PRNGKey(2))
    state = torch_ckpt.restore_latest(str(tmp_path / "m"))
    restored = params_to_numpy(params_from_jax(state["params"], CPU))
    flat_j = jax.tree_util.tree_leaves(params)
    flat_t = jax.tree_util.tree_leaves(restored)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)

    scorer = JaxScorer(metric=cfg.training.metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    graph = model.make_graph(ds.train, pad_to=-(-len(ds.train) // 128) * 128)
    scorer.register_model(JittedModelView(model), params, graph,
                          n_entities=ds.n_entities)
    scorer.finalize_frequency_computation(ds.all_triples())
    want = scorer.compute_scores(ds.test).pretty_print()
    capsys.readouterr()
    torch_evaluate.main(["--settings", exp, "--dataset", TOY, "--split",
                         "test", "--cpu"])
    printed = capsys.readouterr().out
    assert "(step 5)" in printed
    assert printed.rstrip().endswith(want)


def check_train_cli(tmp_path, kind):
    """The train CLI on a tmp_path .exp of this model, on the CPU, in a
    process that never imports JAX."""
    exp = small_exp(tmp_path, kind)
    script = ("import sys\n"
              "from relationprediction_torch import train\n"
              f"train.main(['--settings', {exp!r}, '--dataset', {TOY!r}, "
              f"'--cpu', '--max-iterations', '3'])\n"
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'relationprediction_tpu')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Training done: 3 iterations" in proc.stdout, proc.stdout
    assert "Final test metrics:" in proc.stdout


# ---------------------------------------------------------------------------
# The one-hot-input model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_encode_and_scores_match_jax(name):
    check_encode_and_scores("onehot", name)


@pytest.mark.parametrize("name", CASES)
def test_scorer_ranks_equal_jax(name):
    check_ranks("onehot", name)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_every_gradient_leaf_match_jax(name):
    grads = check_loss_and_grads("onehot", name)
    # the one-hot layer's bases get a gradient in both directions; the
    # unused biases a zero one, as under jax.grad
    for layer in grads["gcn_layers"]:
        for key in ("C_forward", "C_backward", "W_forward", "W_backward",
                    "W_self"):
            assert layer[key].abs().max() > 0, key
        assert not layer["b"].any()


@pytest.mark.parametrize("name", CASES)
def test_params_after_optimizer_steps_match_optax(name):
    check_adam_steps("onehot", name)


def test_param_tree_has_the_one_hot_layer():
    """No input transform; layer 1's bases and self-loop have one row per
    entity, layer 2's one per feature."""
    fresh = check_trees("onehot")
    ds, _, (tcfg, model, params, _) = case("onehot", "synthetic")
    assert model.first_layer_onehot
    assert sorted(params) == ["decoder", "gcn_layers", "relation_embedding"]
    first, second = params["gcn_layers"]
    v, d = ds.n_entities, tcfg.encoder.internal_dimension
    assert tuple(first["W_forward"].shape) == (v, 3, d)
    assert tuple(first["W_self"].shape) == (v, d)
    assert tuple(second["W_forward"].shape) == (d, 3, d)
    # the reference's glorot scale 3 / sqrt(fan_in + fan_out), over (V, d)
    # for the one-hot layer and (d, d) for the other
    for layer, fan_in in zip(fresh["gcn_layers"], (v, d)):
        std = 3.0 / (fan_in + d) ** 0.5
        assert abs(layer["W_forward"].std().item() / std - 1) < 0.1


def test_checkpoint_and_evaluate_cli_carry_the_tree(tmp_path, capsys):
    check_checkpoint_and_evaluate_cli(tmp_path, capsys, "onehot")



def test_tree_unflatten_frees_its_leaves_without_the_cycle_collector():
    """A train step rebuilds four trees of the parameters' size (grads,
    Adam's two moments, the updates): 1.3 GB with the one-hot bases at
    FB15k-237 scale. Once the rebuilt tree and the leaves list are gone,
    nothing may keep a leaf alive until a garbage collection."""
    _, _, (_, _, params, _) = case("onehot", "toy")
    leaves = [torch.zeros_like(p) for p in tree_leaves(params)]
    alive = weakref.ref(leaves[-1])
    enabled = gc.isenabled()
    gc.disable()
    try:
        rebuilt = tree_unflatten(params, leaves)
        assert tree_leaves(rebuilt)[-1] is alive()
        del rebuilt, leaves
        assert alive() is None
    finally:
        if enabled:
            gc.enable()


def test_train_cli_runs_without_input_transform_on_cpu(tmp_path):
    check_train_cli(tmp_path, "onehot")
