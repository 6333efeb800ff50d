"""The MLP decoder (``nonlinear-transform``) through the port on the CPU
against the JAX package, on gcn_block.exp cut to d=20 (2 layers) with a
hidden width D=16: its params carried across, energies, all-entity scores
over blocks of rows, filtered ranks, the tiled loss with every gradient
leaf (device-drawn and host-tiled), and the protocol choice (split and
shared fall back to the tiled loss; the factorized losses refuse it)."""
import dataclasses
import functools
import math
import os

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
from relationprediction_tpu.training.device_sampling import (
    device_negative_sample as jax_negative_sample)
from relationprediction_tpu.training.engine import (
    BatchPipeline as JaxBatchPipeline)
from relationprediction_torch import config as torch_config
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.models import decoders
from relationprediction_torch.models.build import ModelView, build_model
from relationprediction_torch.params import params_from_jax, params_to_numpy
from relationprediction_torch.training.engine import (BatchPipeline, Draws,
                                                      TrainLoop, loss_kind)

from test_torch_negative_protocols import check_against_jax, keep_masks

ROOT = os.path.join(os.path.dirname(__file__), "..")
SETTINGS = os.path.join(ROOT, "settings", "gcn_block.exp")
CPU = torch.device("cpu")
HIDDEN = 16


def small(cfg, ds):
    """gcn_block.exp cut to d=20, B=4 (dr=5), 2 layers, with the MLP
    decoder of hidden width 16 over 20-wide codes."""
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, code_dimension=20,
                                    internal_dimension=20, n_bases=4),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20,
                                    name="nonlinear-transform",
                                    decoder_dimension=HIDDEN,
                                    embedding_width=20),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


@functools.lru_cache(maxsize=None)
def case(name):
    if name == "toy":
        ds = jax_dataset.load(os.path.join(ROOT, "data", "Toy"))
    else:
        ds = jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)
    jcfg = small(jax_config.load(SETTINGS), ds)
    tcfg = small(torch_config.load(SETTINGS), ds)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    # The JAX package's b_pre and b_post start at 0; random values make
    # the checks see them.
    rng = np.random.default_rng(1)
    jparams["decoder"]["b_pre"] = rng.standard_normal(HIDDEN).astype(
        np.float32) * 0.1
    jparams["decoder"]["b_post"] = np.array([0.3], np.float32)
    jgraph = jmodel.make_graph(ds.train,
                               pad_to=-(-len(ds.train) // 128) * 128)
    model = build_model(tcfg, CPU)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    return ds, (jcfg, jmodel, jparams, jgraph), (tcfg, model, params,
                                                 model.make_graph(ds.train))


def test_params_carry_across_and_init_has_the_jax_layout():
    _, (_, _, jparams, _), (_, model, params, _) = case("synthetic")
    assert isinstance(model.decoder, decoders.NonlinearTransform)
    assert sorted(params["decoder"]) == ["W_e1", "W_e2", "W_r",
                                         "W_transform", "b_post", "b_pre"]
    for k, v in jparams["decoder"].items():
        np.testing.assert_array_equal(params["decoder"][k].numpy(),
                                      np.asarray(v))
    back = params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    fresh = model.init_params(torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  params_to_numpy(fresh)) == shapes
    # The JAX package's standard deviations, zero biases.
    dec = model.decoder
    big = decoders.NonlinearTransform(300, 200, 0.01).init(
        torch.Generator().manual_seed(1))
    np.testing.assert_allclose(big["W_e1"].std().item(),
                               math.sqrt(1 / 500), rtol=0.02)
    np.testing.assert_allclose(big["W_transform"].std().item(),
                               math.sqrt(1 / 301), rtol=0.1)
    assert not big["b_pre"].any() and not big["b_post"].any()
    assert (dec.dimension, dec.embedding_width) == (HIDDEN, 20)
    assert dec.factorizable is False


def test_energies_match_jax():
    _, (_, jmodel, jparams, _), (_, model, params, _) = case("synthetic")
    rng = np.random.default_rng(0)
    e1, r, e2 = (rng.standard_normal((50, 20)).astype(np.float32)
                 for _ in range(3))
    want = jmodel.decoder.energies(jparams["decoder"], e1, r, e2)
    got = model.decoder.energies(params["decoder"],
                                 *(torch.from_numpy(a) for a in (e1, r, e2)))
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# The default budget (all rows in one block here) and budgets of one and
# three rows a block.
@pytest.mark.parametrize("rows", [None, 1, 3])
def test_all_entity_scores_match_jax(rows):
    ds, (_, jmodel, jparams, jgraph), (tcfg, model, params, graph) = \
        case("synthetic")
    if rows is not None:
        model = build_model(tcfg, CPU)
        model.decoder.score_budget_bytes = 4 * ds.n_entities * HIDDEN * rows
    triples = ds.test
    for fn in ("score_all_subjects", "score_all_objects"):
        want = np.asarray(getattr(jmodel, fn)(jparams, jgraph, triples))
        got = getattr(model, fn)(params, graph, triples)
        assert got.shape == (len(triples), ds.n_entities)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4,
                                   err_msg=fn)
    # Every candidate row of the broadcast is the triple's own energy.
    t = torch.from_numpy(np.asarray(triples[:5], np.int64))
    enc = model.encode(params, graph, deterministic=True)
    e1, r, e2 = model.gather_codes(enc, t)
    own = model.decoder.energies(params["decoder"], e1, r, e2)
    objs = model.score_all_objects(params, graph, triples[:5],
                                   apply_sigmoid=False)
    np.testing.assert_allclose(objs[torch.arange(5), t[:, 2]].numpy(),
                               own.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["toy", "synthetic"])
def test_filtered_ranks_equal_jax(name):
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


@pytest.mark.parametrize("device_negatives", [True, False])
def test_tiled_loss_and_every_gradient_leaf_match_jax(device_negatives):
    """The MLP's only training route: the tiled loss, on the tiled batch
    drawn on the device (JAX's draws) or tiled on the host."""
    ds, (jcfg, jmodel, jparams, _), (tcfg, model, params, _) = \
        case("synthetic")
    jpipe = JaxBatchPipeline(jmodel, jcfg, ds, np.random.default_rng(0),
                             device_negatives=device_negatives)
    tpipe = BatchPipeline(model, tcfg, ds, np.random.default_rng(0),
                          device_negatives=device_negatives)
    jb, tb = jpipe.next(), tpipe.next()
    key, masks = keep_masks(jcfg, jmodel, model, jb.triples, 0)
    if device_negatives:
        triples, labels, mask = (np.array(a) for a in jax_negative_sample(
            jb.triples, jb.mask, jcfg.training.negative_sample_rate,
            jcfg.entity_count, jax.random.fold_in(key, 777)))
        draws = Draws(tuple(torch.from_numpy(a)
                            for a in (triples, labels, mask)), masks)
    else:
        triples, labels, mask = jb.triples, jb.labels, jb.mask
        np.testing.assert_array_equal(tb.triples.numpy(), triples)
        draws = Draws((), masks)

    def jloss(p):
        return jmodel.loss(p, jb.graph, triples, labels, mask, rng=key,
                           deterministic=False)
    _, grads = check_against_jax(jloss, jparams, model, "tiled", params, tb,
                                 draws)
    assert grads["decoder"]["W_transform"].abs().max() > 0


def test_split_and_shared_fall_back_to_the_tiled_loss():
    """As in the JAX package: with the MLP every mode trains the tiled
    loss, and loss_structured / loss_shared_negatives refuse it."""
    ds, (_, jmodel, jparams, jgraph), (tcfg, model, params, graph) = \
        case("toy")
    for mode in ("binomial", "split", "shared"):
        assert loss_kind(model, mode, True) == "tiled"
        loop = TrainLoop(model, tcfg, ds, prefetch=False,
                         log=lambda line: None, negative_mode=mode)
        assert loop.loss_kind == "tiled"
        batch = loop.pipeline.next()
        draws = loop.draw(batch)
        triples, labels, mask = draws.negatives
        rate = tcfg.training.negative_sample_rate
        assert triples.shape == (len(batch.triples) * (rate + 1), 3)
        _, loss = loop.train_step(params, loop.optimizer.init(params),
                                  batch)
        assert np.isfinite(loss.item())
    t = torch.from_numpy(np.asarray(ds.test, np.int32))
    m = torch.ones(len(t))
    neg = torch.zeros((len(t), 5), dtype=torch.int32)
    for fn, args, jargs in (
            ("loss_structured", (neg, neg), (np.asarray(neg),) * 2),
            ("loss_shared_negatives", (neg[0],), (np.asarray(neg[0]),))):
        with pytest.raises(ValueError, match="does not support"):
            getattr(model, fn)(params, graph, t, m, *args,
                               deterministic=True)
        with pytest.raises(ValueError, match="does not support"):
            getattr(jmodel, fn)(jparams, jgraph, np.asarray(t),
                                np.asarray(m), *jargs, deterministic=True)
    with pytest.raises(ValueError, match="factored binomial"):
        model.loss_binomial_factored(params, graph, t, m, neg,
                                     neg.bool(), deterministic=True)
