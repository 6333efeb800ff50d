"""distmult.exp and complex.exp (the embedding table, no graph) through the
port on the CPU against the JAX package: codes, all-entity scores, raw and
filtered ranks, the factored binomial loss and every gradient leaf for the
same draws, the params after optimizer steps, and the minibatch and
contiguous positive streams."""
import dataclasses
import functools
import pathlib

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
from relationprediction_torch import config as torch_config
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.models.build import ModelView, build_model
from relationprediction_torch.params import (params_from_jax,
                                             params_to_numpy, tree_leaves)
from relationprediction_torch.training.engine import (BatchPipeline,
                                                      TrainLoop,
                                                      loss_and_grads)

from test_torch_train_step import (check_params_after_adam_steps,
                                   jax_draws)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CASES = [(s, d) for s in ("distmult", "complex") for d in ("toy",
                                                          "synthetic")]


def small(cfg, ds, **optimizer):
    """The settings cut to d=20."""
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, code_dimension=20),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
        optimizer=dataclasses.replace(cfg.optimizer, **optimizer),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


@functools.lru_cache(maxsize=None)
def case(settings, data, **optimizer):
    """JAX config, model and params; the port's counterparts."""
    if data == "toy":
        ds = jax_dataset.load(str(ROOT / "data" / "Toy"))
    else:
        ds = jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)
    path = str(ROOT / "settings" / f"{settings}.exp")
    jcfg = small(jax_config.load(path), ds, **optimizer)
    tcfg = small(torch_config.load(path), ds, **optimizer)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.encoder.name == "embedding"
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = build_model(tcfg, CPU)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    return ds, (jcfg, jmodel, jparams), (tcfg, model, params)


@pytest.mark.parametrize("settings,data", CASES)
def test_codes_and_scores_match_jax(settings, data):
    ds, (_, jmodel, jparams), (_, model, params) = case(settings, data)
    assert not model.needs_graph() and model.make_graph(ds.train) is None
    want = jmodel.encode(jparams, None, deterministic=True)
    got = model.encode(params, None, deterministic=True)
    np.testing.assert_array_equal(got.entity_codes.numpy(),
                                  np.asarray(want.entity_codes))
    for fn in ("score_all_subjects", "score_all_objects"):
        want = np.asarray(getattr(jmodel, fn)(jparams, None, ds.test))
        got = getattr(model, fn)(params, None, ds.test)
        assert got.shape == (len(ds.test), ds.n_entities)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=fn)
    t = torch.from_numpy(np.asarray(ds.test, np.int64))
    e1, r, e2 = model.gather_codes(model.encode(params, None,
                                                deterministic=True), t)
    np.testing.assert_allclose(
        model.decoder.energies({}, e1, r, e2).numpy(),
        np.asarray(jmodel.decoder.energies({}, *(a.numpy()
                                                 for a in (e1, r, e2)))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("settings,data", CASES)
def test_scorer_ranks_equal_jax(settings, data):
    ds, (_, jmodel, jparams), (_, model, params) = case(settings, data)

    def summary(scorer, view, p):
        for t in (ds.train, ds.valid, ds.test):
            scorer.register_data(t)
        scorer.register_degrees(ds.train)
        scorer.register_model(view, p, None, n_entities=ds.n_entities)
        scorer.finalize_frequency_computation(ds.all_triples())
        return scorer.compute_scores(ds.test)

    want = summary(JaxScorer(), JittedModelView(jmodel), jparams)
    got = summary(Scorer(), ModelView(model), params)
    np.testing.assert_array_equal(got.raw_ranks, want.raw_ranks)
    np.testing.assert_array_equal(got.filtered_ranks, want.filtered_ranks)
    assert got.results == want.results


def test_params_trees_line_up_with_jax():
    _, (_, _, jparams), (_, model, params) = case("complex", "synthetic")
    assert sorted(params) == ["decoder", "embedding", "relation_embedding"]
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    fresh = model.init_params(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  params_to_numpy(fresh)) == shapes
    assert model.draw_keep_masks(torch.Generator()) == []


def pipelines(settings, data, seed=0, **optimizer):
    ds, (jcfg, jmodel, _), (tcfg, model, _) = case(settings, data,
                                                   **optimizer)
    return (JaxBatchPipeline(jmodel, jcfg, ds, np.random.default_rng(seed),
                             device_negatives=True),
            BatchPipeline(model, tcfg, ds, np.random.default_rng(seed)))


def both_steps(settings, data, jparams, params, jbatch, batch, step):
    """(JAX loss, JAX grads, port loss, port grads) for one batch and one
    set of draws."""
    _, (jcfg, jmodel, _), (_, model, _) = case(settings, data)
    key, values, co, _ = jax_draws(jcfg, jmodel, jbatch.triples, step)

    def jloss(p):
        return jmodel.loss_binomial_factored(
            p, None, jbatch.triples, jbatch.mask, values, co, rng=key,
            deterministic=False)
    want, jgrads = jax.value_and_grad(jloss)(jparams)
    got, grads = loss_and_grads(model, params, batch,
                                torch.from_numpy(values),
                                torch.from_numpy(co), [])
    return float(want), jgrads, float(got), grads


@pytest.mark.parametrize("settings,data", CASES)
def test_loss_and_every_gradient_leaf_match_jax(settings, data):
    ds, (_, _, jparams), _ = case(settings, data)
    jpipe, tpipe = pipelines(settings, data)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    jb, tb = jpipe.next(), tpipe.next()
    # BatchSize unset: every train triple is a positive of every step
    assert tb.graph is None and int(tb.mask.sum()) == len(ds.train)
    np.testing.assert_array_equal(tb.triples.numpy(), jb.triples)
    want, jgrads, got, grads = both_steps(settings, data, jparams, params,
                                          jb, tb, 0)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves) == 2
    for g, jg in zip(leaves, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=1e-6)
        assert g.abs().max() > 0


@pytest.mark.parametrize("settings,data", CASES)
def test_params_after_optimizer_steps_match_optax(settings, data):
    """1 and 3 steps of clip -> Adam -> -lr from the same params, batches
    and draws (test_torch_train_step.check_params_after_adam_steps). An
    entity's row of the table gets the gradient of the few positives and
    corruptions that use it, divided by all (rate + 1) x 1,500 tiled rows,
    so up to 10 % of the entries fall below 1e-6 (5.7 % on the synthetic
    graph) where an R-GCN's mixed codes keep fewer than 1 % there."""
    _, (jcfg, _, jparams), (tcfg, _, _) = case(settings, data)
    jpipe, tpipe = pipelines(settings, data)
    check_params_after_adam_steps(jcfg, tcfg, jparams, jpipe, tpipe,
                                  functools.partial(both_steps, settings,
                                                    data),
                                  max_near_zero=0.1)


@pytest.mark.parametrize("contiguous", [False, True])
def test_minibatch_streams_equal_jax(contiguous):
    """BatchSize=700 of the synthetic graph's 1,500 train triples: random
    draws from the shared numpy stream, or wrapping windows from a
    cursor; the same positives and cursors as the JAX package's."""
    jpipe, tpipe = pipelines("distmult", "synthetic", seed=5,
                             batch_size=700, contiguous_sampling=contiguous)
    for _ in range(4):
        jb, tb = jpipe.next(), tpipe.next()
        np.testing.assert_array_equal(tb.triples.numpy(), jb.triples)
        np.testing.assert_array_equal(tb.mask.numpy(), jb.mask)
        assert tpipe.state() == jpipe.state()
    assert (tpipe.state()["cursor"] == 1300) == contiguous


def test_fit_trains_the_embedding_model():
    ds, _, (tcfg, model, _) = case("complex", "toy")
    loop = TrainLoop(model, tcfg, ds, seed=0, log=lambda line: None)
    result = loop.fit(max_iterations=6)
    assert result.iterations == 6
    assert all(s["launches"] == s["twin_launches"] == 0
               for s in result.steps)
    assert result.steps[-1]["loss"] < result.steps[0]["loss"]
