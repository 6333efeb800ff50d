"""The train step of gcn_block.exp, port (CPU plain path) against JAX on
the CPU: batches, the factored binomial loss and every gradient leaf for
the same params and draws, and params after optimizer steps."""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.data import synthetic as jax_synthetic
from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_tpu.training.device_sampling import (
    device_negative_parts)
from relationprediction_tpu.training.engine import (
    BatchPipeline as JaxBatchPipeline)
from relationprediction_tpu.training.optimizers import (
    build_optimizer as jax_optimizer)
from relationprediction_torch import config as torch_config
from relationprediction_torch.models.build import build_model
from relationprediction_torch.params import params_from_jax, tree_leaves
from relationprediction_torch.training.engine import (BatchPipeline,
                                                      TrainLoop,
                                                      loss_and_grads)
from relationprediction_torch.training.optimizers import (apply_updates,
                                                          build_optimizer)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SETTINGS = os.path.join(ROOT, "settings", "gcn_block.exp")
CPU = torch.device("cpu")
CASES = ["toy", "synthetic"]


def small(cfg, ds, graph_batch_size=None):
    """gcn_block.exp cut to d=20, B=4 (dr=5), 2 layers."""
    training = cfg.training
    if graph_batch_size is not None:
        training = dataclasses.replace(training,
                                       graph_batch_size=graph_batch_size)
    return dataclasses.replace(
        cfg, training=training,
        encoder=dataclasses.replace(cfg.encoder, code_dimension=20,
                                    internal_dimension=20, n_bases=4),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


def dataset(name):
    if name == "toy":
        return jax_dataset.load(os.path.join(ROOT, "data", "Toy"))
    return jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)


@functools.lru_cache(maxsize=None)
def case(name, graph_batch_size=None):
    ds = dataset(name)
    jcfg = small(jax_config.load(SETTINGS), ds, graph_batch_size)
    tcfg = small(torch_config.load(SETTINGS), ds, graph_batch_size)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = build_model(tcfg, CPU)
    return ds, (jcfg, jmodel, jparams), (tcfg, model)


def pipelines(name, seed=0, graph_batch_size=None):
    ds, (jcfg, jmodel, _), (tcfg, model) = case(name, graph_batch_size)
    jpipe = JaxBatchPipeline(jmodel, jcfg, ds, np.random.default_rng(seed),
                             device_negatives=True)
    tpipe = BatchPipeline(model, tcfg, ds, np.random.default_rng(seed))
    return jpipe, tpipe


def jax_draws(jcfg, jmodel, positives, step):
    """JAX's negatives and the keep-masks JAX's encoder draws, as numpy."""
    key = jax.random.PRNGKey(100 + step)
    values, co = device_negative_parts(
        positives, jcfg.training.negative_sample_rate, jcfg.entity_count,
        jax.random.fold_in(key, 777))
    e = jcfg.encoder
    masks = [np.array(jax.random.bernoulli(
        jax.random.fold_in(key, 100 + layer), e.dropout_keep_probability,
        (jcfg.entity_count, e.internal_dimension)))
        for layer in range(e.n_layers)]
    return key, np.array(values), np.array(co), masks


def both_steps(name, jparams, params, jbatch, batch, step):
    """(JAX loss, JAX grads, port loss, port grads) for one batch and one
    set of draws."""
    _, (jcfg, jmodel, _), (_, model) = case(name)
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
def test_pipeline_gives_jax_graphs_and_positives(name):
    # the synthetic graph samples 600 of its 1,500 edges per batch
    jpipe, tpipe = pipelines(name, seed=3,
                             graph_batch_size=None if name == "toy"
                             else 600)
    for _ in range(2):
        jb, tb = jpipe.next(), tpipe.next()
        np.testing.assert_array_equal(tb.triples.numpy(), jb.triples)
        np.testing.assert_array_equal(tb.mask.numpy(), jb.mask)
        g = jb.graph
        real = np.asarray(g.mask) > 0
        want = np.stack([np.asarray(g.senders)[real],
                         np.asarray(g.relations)[real],
                         np.asarray(g.receivers)[real]], axis=1)
        fwd = tb.graph.fwd
        tgt = np.repeat(np.arange(fwd.n_rows), np.diff(fwd.row_ptr.numpy()))
        got = np.stack([fwd.src.numpy(), fwd.rel.numpy(), tgt], axis=1)
        assert len(got) == tpipe.split_size
        np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                      want[np.lexsort(want.T[::-1])])


@pytest.mark.parametrize("name", CASES)
def test_loss_and_every_gradient_leaf_match_jax(name):
    _, (_, _, jparams), _ = case(name)
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
    assert any(g.abs().max() > 0 for g in leaves)


def check_params_after_adam_steps(jcfg, tcfg, jparams, jpipe, tpipe,
                                  both_steps_fn, max_near_zero=0.01):
    """1 and 3 steps of clip -> Adam -> -lr from the same params, batches
    and draws (``both_steps_fn(jparams, params, jbatch, batch, step)``
    gives JAX's and the port's loss and gradients), the params compared
    after steps 1 and 3.

    Adam's first step moves a weight by lr * g / (|g| + eps), eps = 1e-8.
    Where |g| is a few eps, an f32 difference of 1e-9 in g (well inside
    the gradient checks' atol of 1e-6; the summation order of torch's CPU
    kernels follows the thread count) moves the weight by ~1e-5. So the
    entries whose JAX gradient fell below 1e-6, but not to 0, at some step
    are held within lr per step, all others within 1e-5; fewer than
    ``max_near_zero`` (1 %) of the entries may be of the first kind."""
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    jopt, opt = jax_optimizer(jcfg.optimizer), build_optimizer(tcfg.optimizer)
    jstate, state = jopt.init(jparams), opt.init(params)
    lr = tcfg.optimizer.learning_rate
    near_zero = [np.zeros(p.shape, bool) for p in tree_leaves(params)]
    for step in range(1, 4):
        _, jgrads, _, grads = both_steps_fn(jparams, params, jpipe.next(),
                                            tpipe.next(), step)
        for mask, jg in zip(near_zero, jax.tree_util.tree_leaves(jgrads)):
            jg = np.asarray(jg)
            mask |= (np.abs(jg) < 1e-6) & (jg != 0)
        updates, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        updates, state = opt.update(grads, state)
        apply_updates(params, updates)
        if step in (1, 3):
            for p, jp, mask in zip(tree_leaves(params),
                                   jax.tree_util.tree_leaves(jparams),
                                   near_zero):
                diff = np.abs(p.numpy() - np.asarray(jp))
                assert diff[~mask].max(initial=0.0) <= 1e-5
                assert diff[mask].max(initial=0.0) <= lr * step
    assert sum(m.sum() for m in near_zero) \
        < max_near_zero * sum(m.size for m in near_zero)
    assert int(state["count"]) == 3


@pytest.mark.parametrize("name", CASES)
def test_params_after_optimizer_steps_match_optax(name):
    """See check_params_after_adam_steps: entries with a tiny gradient
    within lr a step, all others within 1e-5."""
    _, (jcfg, _, jparams), (tcfg, _) = case(name)
    jpipe, tpipe = pipelines(name)
    check_params_after_adam_steps(jcfg, tcfg, jparams, jpipe, tpipe,
                                  functools.partial(both_steps, name))


def test_fit_reports_on_the_reference_cadence():
    ds, _, (tcfg, model) = case("toy")
    tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, report_train_loss_every=3))
    lines = []
    loop = TrainLoop(model, tcfg, ds, seed=0, log=lines.append)
    result = loop.fit(max_iterations=8)
    assert result.iterations == 8 and len(result.steps) == 8
    assert lines[0].startswith("Initial loss: ")
    assert [line.split(":")[0] for line in lines[1:]] == [
        "Average train loss for iteration 1-3",
        "Average train loss for iteration 4-6"]
    assert all(np.isfinite(s["loss"]) for s in result.steps)
    assert result.last_loss == result.steps[-1]["loss"]
    # the CPU plain path launches no kernel and has no device timing
    assert all(s["launches"] == s["twin_launches"] == 0
               and s["step_ms"] is None for s in result.steps)
    assert loop.timer.summary()["steps"] == 8


def test_fit_trains_until_the_early_stopper_fires():
    """fit() without max_iterations (none in the settings either) trains
    until the early stopper fires: a score that stops rising after the
    burn-in ends the run at that check."""
    ds, _, (tcfg, model) = case("toy")
    tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, early_stopping_check_every=2,
        early_stopping_burnin=4))
    assert tcfg.optimizer.max_iterations is None
    scores = iter([0.1, 0.2, 0.3, 0.3, 0.9])
    lines = []
    loop = TrainLoop(model, tcfg, ds, log=lines.append,
                     scoring_function=lambda params: next(scores))
    result = loop.fit()
    assert (result.iterations, result.stopped_early, result.best_score) \
        == (8, True, 0.3)
    assert lines[-1] == "Stopping criterion reached."


def test_decoder_losses_match_jax():
    """weighted_ce_loss, masked_mean and the tiled regularization (the
    loss terms of the other protocols) on random codes with a mask."""
    from relationprediction_tpu.models import decoders as jax_decoders
    from relationprediction_torch.models import decoders
    rng = np.random.default_rng(0)
    e1, r, e2 = (rng.standard_normal((40, 8)).astype(np.float32)
                 for _ in range(3))
    x = (4 * rng.standard_normal(40)).astype(np.float32)
    y = (rng.random(40) < 0.3).astype(np.float32)
    mask = (rng.random(40) < 0.8).astype(np.float32)
    t = [torch.from_numpy(a) for a in (e1, r, e2, x, y, mask)]
    np.testing.assert_allclose(
        decoders.weighted_ce_loss(t[3], t[4], t[5]).item(),
        float(jax_decoders.weighted_ce_loss(x, y, mask)), rtol=1e-6)
    np.testing.assert_allclose(
        decoders.weighted_ce_loss(t[3], t[4]).item(),
        float(jax_decoders.weighted_ce_loss(x, y)), rtol=1e-6)
    want = jax_decoders.BilinearDiag(8, 0.01).regularization({}, e1, r, e2,
                                                             mask)
    got = decoders.BilinearDiag(8, 0.01).regularization({}, *t[:3], t[5])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
