"""The whole serving slice of gcn_block.exp, port against JAX on the CPU:
encode, all-entity scores, raw/filtered ranks, MRR and Hits@k."""
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
from relationprediction_tpu.evaluation import Scorer as JaxScorer
from relationprediction_tpu.models.build import JittedModelView
from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_torch import config as torch_config
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.models.build import ModelView, build_model
from relationprediction_torch.params import params_from_jax, params_to_numpy

ROOT = os.path.join(os.path.dirname(__file__), "..")
SETTINGS = os.path.join(ROOT, "settings", "gcn_block.exp")
CPU = torch.device("cpu")


def small(cfg, ds):
    """gcn_block.exp cut to d=20, B=4 (dr=5), 2 layers."""
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, code_dimension=20,
                                    internal_dimension=20, n_bases=4),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


@functools.lru_cache(maxsize=None)
def case(name):
    """JAX model, params, graph and outputs; the port's counterparts."""
    if name == "toy":
        ds = jax_dataset.load(os.path.join(ROOT, "data", "Toy"))
    else:
        ds = jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)
    jcfg = small(jax_config.load(SETTINGS), ds)
    tcfg = small(torch_config.load(SETTINGS), ds)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)

    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jgraph = jmodel.make_graph(ds.train,
                               pad_to=-(-len(ds.train) // 128) * 128)
    model = build_model(tcfg, CPU)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    graph = model.make_graph(ds.train)
    return ds, (jmodel, jparams, jgraph), (model, params, graph)


CASES = ["toy", "synthetic"]


@pytest.mark.parametrize("name", CASES)
def test_encode_matches_jax(name):
    _, (jmodel, jparams, jgraph), (model, params, graph) = case(name)
    want = jmodel.encode(jparams, jgraph, deterministic=True)
    got = model.encode(params, graph, deterministic=True)
    np.testing.assert_allclose(got.entity_codes.numpy(),
                               np.asarray(want.entity_codes),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got.relation_codes.numpy(),
                                  np.asarray(want.relation_codes))


@pytest.mark.parametrize("name", CASES)
def test_all_entity_scores_match_jax(name):
    ds, (jmodel, jparams, jgraph), (model, params, graph) = case(name)
    triples = ds.test
    for fn in ("score_all_subjects", "score_all_objects"):
        want = np.asarray(getattr(jmodel, fn)(jparams, jgraph, triples))
        got = getattr(model, fn)(params, graph, triples)
        assert got.shape == (len(triples), ds.n_entities)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4,
                                   err_msg=fn)


@pytest.mark.parametrize("name", CASES)
def test_scorer_ranks_equal_jax(name):
    ds, (jmodel, jparams, jgraph), (model, params, graph) = case(name)

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
    for f in ("in_degrees", "out_degrees", "vertex_freqs", "relation_freqs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_model_view_encodes_once_per_params_and_graph():
    ds, _, (model, params, graph) = case("toy")
    view = ModelView(model)
    first = view.encoded(params, graph)
    assert view.encoded(params, graph) is first
    view.score_all_objects(params, graph, ds.test)
    assert view.encoded(params, graph) is first
    assert view.encoded(dict(params), graph) is not first
    view.invalidate()
    assert view.encoded(params, graph) is not first


def test_params_round_trip_and_init_layout():
    _, (_, jparams, _), (model, params, _) = case("synthetic")
    back = params_to_numpy(params)
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    # init_params draws from a torch.Generator: JAX's tree layout, other bits
    fresh = model.init_params(torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  params_to_numpy(fresh)) == shapes
    again = model.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(fresh["gcn_layers"][1]["W_forward"],
                       again["gcn_layers"][1]["W_forward"])


def test_train_mode_dropout_touches_only_the_self_loop():
    _, _, (model, params, graph) = case("synthetic")
    det = model.encode(params, graph, deterministic=True).entity_codes
    keep_all = dataclasses.replace(
        model.config, encoder=dataclasses.replace(
            model.config.encoder, dropout_keep_probability=1.0))
    model_keep = build_model(keep_all, CPU)
    same = model_keep.encode(params, graph, deterministic=False,
                             generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(same.entity_codes, det)
    with pytest.raises(ValueError):
        model.encode(params, graph, deterministic=False)
    dropped = model.encode(params, graph, deterministic=False,
                           generator=torch.Generator().manual_seed(3))
    assert not torch.allclose(dropped.entity_codes, det)


def test_unported_configurations_raise():
    """Nothing the JAX package accepts raises any more: every message and
    decoder-stream precision builds (bf16 as "bfloat16" or "bf16", read as
    the JAX package reads them), as do the configurations that raised
    before them; an unknown precision is refused by the config."""
    ds = jax_synthetic.generate(30, 3, 60, seed=0)
    base = small(torch_config.load(SETTINGS), ds)
    for message in ("float32", "bfloat16", "bf16"):
        for stream in ("float32", "bfloat16", "bf16"):
            model = build_model(dataclasses.replace(
                base, encoder=dataclasses.replace(
                    base.encoder, message_precision=message),
                decoder=dataclasses.replace(
                    base.decoder, stream_precision=stream)), CPU)
            for got, precision in ((model.agg_dtype, message),
                                   (model.stream_dtype, stream)):
                assert got == (None if precision == "float32"
                               else torch.bfloat16)
    for enc in (dict(use_input_transform=False, random_input=True),
                dict(name="variational_embedding")):
        build_model(dataclasses.replace(
            base, encoder=dataclasses.replace(base.encoder, **enc)), CPU)
    with pytest.raises(ValueError, match="precision"):
        dataclasses.replace(base.encoder, message_precision="float16")


def test_mlp_decoder_model_builds():
    """The MLP decoder (nonlinear-transform) builds, with its widths from
    the settings, and scores every entity."""
    from relationprediction_torch.models.decoders import NonlinearTransform
    ds = jax_synthetic.generate(30, 3, 60, seed=0)
    base = small(torch_config.load(SETTINGS), ds)
    cfg = dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, name="nonlinear-transform", decoder_dimension=12,
        embedding_width=20))
    model = build_model(cfg, CPU)
    assert isinstance(model.decoder, NonlinearTransform)
    params = model.init_params(torch.Generator().manual_seed(0))
    assert params["decoder"]["W_e1"].shape == (20, 12)
    scores = model.score_all_objects(params, model.make_graph(ds.train),
                                     ds.train[:4])
    assert scores.shape == (4, 30) and torch.isfinite(scores).all()
