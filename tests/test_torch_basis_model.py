"""gcn_basis.exp through the port on the CPU against the JAX package: the
serving slice (encode, all-entity scores, raw/filtered ranks), the train
step (loss and every gradient leaf for the same draws), the params after
optimizer steps, and the train CLI."""
import dataclasses
import functools
import os
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
from relationprediction_tpu.training.engine import (
    BatchPipeline as JaxBatchPipeline)
from relationprediction_tpu.training.optimizers import (
    build_optimizer as jax_optimizer)
from relationprediction_torch import config as torch_config
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.models.build import ModelView, build_model
from relationprediction_torch.params import (params_from_jax,
                                             params_to_numpy, tree_leaves)
from relationprediction_torch.training.engine import (BatchPipeline,
                                                      loss_and_grads)
from relationprediction_torch.training.optimizers import build_optimizer

from test_torch_train_step import (check_params_after_adam_steps,
                                   jax_draws)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SETTINGS = str(ROOT / "settings" / "gcn_basis.exp")
CPU = torch.device("cpu")
CASES = ["toy", "synthetic"]


def small(cfg, ds):
    """gcn_basis.exp cut to d=20, B=3, 2 layers."""
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, code_dimension=20,
                                    internal_dimension=20, n_bases=3),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


@functools.lru_cache(maxsize=None)
def case(name):
    """JAX config, model, params and graph; the port's counterparts."""
    if name == "toy":
        ds = jax_dataset.load(os.path.join(ROOT, "data", "Toy"))
    else:
        ds = jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)
    jcfg = small(jax_config.load(SETTINGS), ds)
    tcfg = small(torch_config.load(SETTINGS), ds)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.encoder.gcn_variant == "basis"
    jmodel = jax_build(jcfg)
    assert jmodel.preferred_staircase2  # the JAX side runs TPU kernel 2
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jgraph = jmodel.make_graph(ds.train,
                               pad_to=-(-len(ds.train) // 128) * 128)
    model = build_model(tcfg, CPU)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    return ds, (jcfg, jmodel, jparams, jgraph), \
        (tcfg, model, params, model.make_graph(ds.train))


@pytest.mark.parametrize("name", CASES)
def test_encode_and_scores_match_jax(name):
    ds, (_, jmodel, jparams, jgraph), (_, model, params, graph) = case(name)
    want = jmodel.encode(jparams, jgraph, deterministic=True)
    got = model.encode(params, graph, deterministic=True)
    np.testing.assert_allclose(got.entity_codes.numpy(),
                               np.asarray(want.entity_codes),
                               rtol=2e-4, atol=2e-4)
    for fn in ("score_all_subjects", "score_all_objects"):
        want = np.asarray(getattr(jmodel, fn)(jparams, jgraph, ds.test))
        got = getattr(model, fn)(params, graph, ds.test)
        assert got.shape == (len(ds.test), ds.n_entities)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4,
                                   err_msg=fn)


@pytest.mark.parametrize("name", CASES)
def test_scorer_ranks_equal_jax(name):
    ds, (_, jmodel, jparams, jgraph), (_, model, params, graph) = case(name)

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


def test_params_and_optimizer_state_trees_line_up_with_jax():
    _, (jcfg, _, jparams, _), (tcfg, model, params, _) = case("synthetic")
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(params_to_numpy(params))
    assert len(flat_j) == len(flat_t) == len(tree_leaves(params))
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert sorted(params["gcn_layers"][0]) == [
        "C_backward", "C_forward", "W_backward", "W_forward", "W_self", "b"]
    # init_params draws from a torch.Generator: JAX's tree layout, other bits
    fresh = model.init_params(torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  params_to_numpy(fresh)) == shapes
    # Adam's mu and nu: one leaf per param, in optax's order and shapes
    jstate = jax_optimizer(jcfg.optimizer).init(jparams)
    state = build_optimizer(tcfg.optimizer).init(params)
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    for key in ("mu", "nu"):
        want = [np.asarray(a).shape
                for a in jax.tree_util.tree_leaves(getattr(adam, key))]
        assert [tuple(t.shape) for t in tree_leaves(state[key])] == want


def pipelines(name, seed=0):
    ds, (jcfg, jmodel, _, _), (tcfg, model, _, _) = case(name)
    return (JaxBatchPipeline(jmodel, jcfg, ds, np.random.default_rng(seed),
                             device_negatives=True),
            BatchPipeline(model, tcfg, ds, np.random.default_rng(seed)))


def both_steps(name, jparams, params, jbatch, batch, step):
    """(JAX loss, JAX grads, port loss, port grads) for one batch and one
    set of draws."""
    _, (jcfg, jmodel, _, _), (_, model, _, _) = case(name)
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


@pytest.mark.parametrize("name", CASES)
def test_loss_and_every_gradient_leaf_match_jax(name):
    _, (_, _, jparams, _), _ = case(name)
    jpipe, tpipe = pipelines(name)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    want, jgrads, got, grads = both_steps(name, jparams, params,
                                          jpipe.next(), tpipe.next(), 0)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    for g, jg in zip(leaves, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=1e-6)
    # the coefficients and bases of both directions get a gradient; the
    # unused bias a zero one, as under jax.grad
    layer = grads["gcn_layers"][0]
    for key in ("C_forward", "C_backward", "W_forward", "W_backward"):
        assert layer[key].abs().max() > 0, key
    assert not layer["b"].any()


@pytest.mark.parametrize("name", CASES)
def test_params_after_optimizer_steps_match_optax(name):
    """1 and 3 steps of clip -> Adam -> -lr from the same params, batches
    and draws: entries with a tiny gradient within lr a step, all others
    within 1e-5 (test_torch_train_step.check_params_after_adam_steps)."""
    _, (jcfg, _, jparams, _), (tcfg, _, _, _) = case(name)
    jpipe, tpipe = pipelines(name)
    check_params_after_adam_steps(jcfg, tcfg, jparams, jpipe, tpipe,
                                  functools.partial(both_steps, name))


def test_train_cli_runs_gcn_basis_on_cpu_without_jax():
    script = ("import sys\n"
              "from relationprediction_torch import train\n"
              f"train.main(['--settings', {SETTINGS!r}, '--dataset', "
              f"{str(ROOT / 'data' / 'Toy')!r}, '--cpu', "
              f"'--max-iterations', '3'])\n"
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'relationprediction_tpu')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Training done: 3 iterations" in proc.stdout, proc.stdout
    assert "Final test metrics:" in proc.stdout


def test_block_layer_on_one_hot_input_raises_as_in_jax():
    """A block-diagonal first layer needs dense input: without an input
    transform the JAX package raises ValueError when it encodes
    (``encoders.py:209-212``); the port raises it when it builds the
    layer's parameters."""
    ds, _, _ = case("toy")
    block = str(ROOT / "settings" / "gcn_block.exp")
    jcfg, tcfg = (dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, use_input_transform=False, code_dimension=20,
        internal_dimension=20, n_bases=4), decoder=dataclasses.replace(
        cfg.decoder, code_dimension=20)).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))
        for cfg in (jax_config.load(block), torch_config.load(block)))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="dense input"):
        jmodel.encode(jparams, jmodel.make_graph(ds.train, pad_to=128),
                      deterministic=True)
    model = build_model(tcfg, CPU)
    with pytest.raises(ValueError, match="dense input"):
        model.init_params(torch.Generator().manual_seed(0))
