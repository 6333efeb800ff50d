"""bf16 message and stream precision through whole models, continued from
test_torch_bf16_model.py (its helpers, tolerances and rules): the losses
and gradients of the configurations whose layers sum on kernel 3 (gcn_diag,
basis_plus_diag) and of DistMult on the 1,100-entity graph, where the
fused energy backwards run; the configurations that JAX runs in f32
whatever the precision (the stored variant, 'local' and 'none' graphs),
which give the f32 bits; a 15-step fit on data/Toy that lowers the loss;
and the fused energies taken inside the model."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_torch import config as torch_config
from relationprediction_torch.graph import build_graph_batch
from relationprediction_torch.models.build import build_model
from relationprediction_torch.params import params_from_jax
from relationprediction_torch.training.engine import TrainLoop
from test_torch_bf16_model import (BF16, CPU, KINDS, LOSS_KINDS, LOSSES,
                                   ROOT, case, check_losses_and_gradients,
                                   dataset, draws, port_loss, small)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kind", [k for k in KINDS if k not in LOSS_KINDS])
def test_losses_and_gradients_match_jax_bf16(kind, loss):
    check_losses_and_gradients(kind, loss)


def same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kind", ["block", "basis", "diag"])
@pytest.mark.parametrize("normalization", ["local", "none"])
def test_local_and_none_graphs_sum_in_f32(kind, normalization):
    """A graph built with 'local' or 'none' weights: JAX takes its f32
    segment sum for those (``encoders.py:328-345``), so the port's bf16
    configuration encodes to the f32 configuration's bits; the same
    config on the 'global' graph does not."""
    ds, _, (model16, params, graph) = case(kind, True)
    model32 = case(kind, False)[2][0]
    other = build_graph_batch(ds.train, ds.n_entities, ds.n_relations,
                              normalization)
    assert other.normalization == normalization
    assert same_bits(
        model16.encode(params, other, deterministic=True).entity_codes,
        model32.encode(params, other, deterministic=True).entity_codes)
    assert not same_bits(
        model16.encode(params, graph, deterministic=True).entity_codes,
        model32.encode(params, graph, deterministic=True).entity_codes)


def test_stored_variant_runs_in_f32():
    """The stored-message variant: its test-mode encode ('none' weights)
    and ``loss_stateful`` (no stream cast, no message dtype, as JAX's
    ``encode_stateful``) give the f32 bits under a bf16 configuration, in
    the JAX package as in the port."""
    ds = dataset("synthetic")
    path = str(ROOT / "settings" / "gcn_basis.exp")
    out = {}
    stored = dict(store_edge_data=True)
    for bf16 in (True, False):
        jcfg = small(jax_config.load(path), ds, stored, bf16)
        tcfg = small(torch_config.load(path), ds, stored, bf16)
        jmodel = jax_build(jcfg)
        jparams = jmodel.init_params(jax.random.PRNGKey(0))
        jgraph = jmodel.make_graph(
            ds.train, pad_to=-(-len(ds.train) // 128) * 128)
        model = build_model(tcfg, CPU)
        assert model.has_state
        params = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), CPU)
        graph = model.make_graph(ds.train)
        triples = torch.from_numpy(np.asarray(ds.train[:600], np.int32))
        ones = torch.ones(600)
        masks = [torch.ones(ds.n_entities, 20, dtype=torch.bool)] * 2
        loss, state = model.loss_stateful(
            params, model.init_cache_state(), graph,
            torch.arange(len(ds.train)), triples, ones, ones,
            keep_masks=masks)
        out[bf16] = (np.asarray(jmodel.encode(jparams, jgraph,
                                              deterministic=True)
                                .entity_codes),
                     model.encode(params, graph,
                                  deterministic=True).entity_codes,
                     loss, state)
    np.testing.assert_array_equal(out[True][0], out[False][0])
    assert same_bits(out[True][1], out[False][1])
    assert same_bits(out[True][2], out[False][2])
    for a, b in zip(out[True][3], out[False][3]):
        for key in a:
            assert same_bits(a[key], b[key]), key


def test_bf16_fit_lowers_the_loss():
    """gcn_basis with both precisions bf16 on data/Toy: a fit of one step,
    then 15 more from there, ends lower than it began
    (tests/test_bf16_streams.py::test_bf16_streams_learn)."""
    ds = jax_dataset.load(str(ROOT / "data" / "Toy"))
    path = str(ROOT / "settings" / "gcn_basis.exp")
    cfg = small(torch_config.load(path), ds, {}, True)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, code_dimension=16, internal_dimension=16, n_bases=4),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=16))
    model = build_model(cfg, CPU)
    assert model.agg_dtype == model.stream_dtype == BF16
    loop = TrainLoop(model, cfg, ds, seed=0, prefetch=False,
                     log=lambda line: None)
    first = loop.fit(max_iterations=1)
    more = loop.fit(first.params, first.opt_state, max_iterations=15,
                    start_iteration=1)
    assert np.isfinite(more.last_loss)
    assert more.last_loss < first.last_loss


def test_fused_energies_run_in_the_model(monkeypatch):
    """On the 1,100-entity graph the factored and split losses take the
    fused energy backwards (kernel 3 on the device; its plain version
    here), as JAX's do."""
    from relationprediction_torch.ops import neg_energy
    _, _, (model, params, _) = case("distmult_fused", True)
    seen = []
    for name in ("_Fused", "_SingleFused"):
        original = getattr(neg_energy, name).apply

        def spy(*args, _original=original, _name=name):
            seen.append(_name)
            return _original(*args)
        monkeypatch.setattr(getattr(neg_energy, name), "apply", spy)
    for loss in ("factored", "split"):
        positives, mask, _, neg, masks = draws("distmult_fused", loss)
        port_loss(model, params, None, loss, positives, mask, neg, masks)
    assert seen == ["_Fused", "_SingleFused", "_SingleFused"]
