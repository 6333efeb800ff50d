"""The one-hot-input R-GCN (settings/gcn_basis.exp with UseInputTransform=No)
through the port on the CPU against the JAX package: encode, all-entity
scores and exact ranks; loss and every gradient leaf for the same draws and
masks; params after 1 and 3 Adam steps; the param tree through
params_from_jax and a checkpoint; the train and evaluate CLIs.

Every layer of this model sums per-edge messages with staircase_aggregate
(TPU kernel 3): the JAX side runs that kernel in Pallas interpret mode.
The check functions here serve every configuration of ``MODELS``: the
tests of gcn_diag, the other layer variants, the variational encoders and
the encoder extras (tests/test_torch_{diag_model,layer_variants,
variational,encoder_extras}.py) import them. A configuration whose encode
draws noise (random input, variational) gets JAX's own draws
(``jax_noise``)."""
import dataclasses
import functools
import gc
import os
import weakref
import pathlib
import subprocess
import sys

import re

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.data import synthetic as jax_synthetic
from relationprediction_tpu.evaluation import Scorer as JaxScorer
from relationprediction_tpu.models import initializers as jax_init
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
from relationprediction_torch.models.build import (EncoderNoise, ModelView,
                                                   build_model)
from relationprediction_torch.params import (params_from_jax,
                                             params_to_numpy, tree_leaves,
                                             tree_unflatten)
from relationprediction_torch.training import checkpoint as torch_ckpt
from relationprediction_torch.training.engine import (BatchPipeline,
                                                      loss_and_grads)
from relationprediction_torch.training.optimizers import build_optimizer

from test_torch_train_step import check_params_after_adam_steps, jax_draws

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOY = str(ROOT / "data" / "Toy")
CPU = torch.device("cpu")
CASES = ["toy", "synthetic"]
# Each configuration: the shipped settings file it derives from (as
# tests/test_model_variants.py derives them) and its encoder changes,
# cut to d=20 by ``small`` (a code dimension of 16 where an output stage
# maps the layers' 20 onto it).
MODELS = {
    "onehot": ("gcn_basis", dict(use_input_transform=False)),
    "diag": ("gcn_basis", dict(name="gcn_diag")),
    "plus_diag": ("gcn_basis", dict(add_diagonal=True)),
    "times_diag": ("gcn_basis", dict(diagonal_coefficients=True)),
    "times_diag_onehot": ("gcn_basis", dict(diagonal_coefficients=True,
                                            use_input_transform=False)),
    "stored": ("gcn_basis", dict(store_edge_data=True)),
    # One layer, as tests/test_model_variants.py cuts it: with two, the
    # reference's log sigma reaches ~20 at init here, exp(2 log sigma) in
    # the KL ~1e17, and gradient entries of ~1e12 cancel in f32.
    "vgcn": ("gcn_basis", dict(name="variational_gcn_basis",
                               code_dimension=16, n_layers=1)),
    "vemb": ("distmult", dict(name="variational_embedding")),
    "highway": ("gcn_block", dict(skip_connections="Highway")),
    "highway_onehot": ("gcn_basis", dict(skip_connections="Highway",
                                         use_input_transform=False)),
    "residual_out": ("gcn_block", dict(skip_connections="Residual",
                                       use_output_transform=True,
                                       code_dimension=16)),
    "random": ("gcn_block", dict(use_input_transform=False,
                                 random_input=True)),
    "partial": ("gcn_block", dict(use_input_transform=False,
                                  partially_random_input=True)),
}
# The .exp lines that give the same configurations.
EXP_LINES = {
    "onehot": [("UseInputTransform=Yes", "UseInputTransform=No")],
    "diag": [("Name=gcn_basis", "Name=gcn_diag")],
    "plus_diag": [("AddDiagonal=No", "AddDiagonal=Yes")],
    "times_diag": [("DiagonalCoefficients=No", "DiagonalCoefficients=Yes")],
    "times_diag_onehot": [("DiagonalCoefficients=No",
                           "DiagonalCoefficients=Yes"),
                          ("UseInputTransform=Yes", "UseInputTransform=No")],
    "stored": [("StoreEdgeData=No", "StoreEdgeData=Yes")],
    "vgcn": [("Name=gcn_basis", "Name=variational_gcn_basis"),
             ("NumberOfLayers=2", "NumberOfLayers=1")],
    "vemb": [("Name=embedding", "Name=variational_embedding")],
    "highway": [("SkipConnections=None", "SkipConnections=Highway")],
    "highway_onehot": [("SkipConnections=None", "SkipConnections=Highway"),
                       ("UseInputTransform=Yes", "UseInputTransform=No")],
    "residual_out": [("SkipConnections=None", "SkipConnections=Residual"),
                     ("UseOutputTransform=No", "UseOutputTransform=Yes")],
    "random": [("UseInputTransform=Yes", "UseInputTransform=No"),
               ("RandomInput=No", "RandomInput=Yes")],
    "partial": [("UseInputTransform=Yes", "UseInputTransform=No"),
                ("PartiallyRandomInput=No", "PartiallyRandomInput=Yes")],
}


def settings_path(kind) -> str:
    return str(ROOT / "settings" / f"{MODELS[kind][0]}.exp")
# Codes and scores: a dense basis layer multiplies per edge in JAX
# (basis_messages_chunked) and per vertex in the port, the same function
# rounded otherwise (as in tests/test_torch_basis_model.py); kernel 3 is
# exact up to its sum order.
TOL = dict(rtol=2e-4, atol=2e-4)


def small(cfg, ds, kind):
    """The settings as ``kind`` (MODELS), cut to d=20 and B=3 bases (4
    blocks of 5 for a block layer), 2 layers."""
    enc = {"code_dimension": 20, "internal_dimension": 20,
           "n_bases": 4 if cfg.encoder.gcn_variant == "block" else 3,
           **MODELS[kind][1]}
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, **enc),
        decoder=dataclasses.replace(cfg.decoder,
                                    code_dimension=enc["code_dimension"]),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


def dataset(name):
    if name == "toy":
        return jax_dataset.load(TOY)
    return jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)


# The configurations whose block and basis layers take the fused kernels
# (TPU kernels 1-2) in the port; every other R-GCN layer here sums per-edge
# messages with kernel 3.
FUSED = ("vgcn", "highway", "residual_out", "random", "partial")


@functools.lru_cache(maxsize=None)
def case(kind, name):
    """JAX config, model and params and serving graph (with TPU kernel 3's
    layouts, and the fused layouts where its model asks for them); the
    port's counterparts. No graph for the embedding encoders."""
    ds = dataset(name)
    jcfg = small(jax_config.load(settings_path(kind)), ds, kind)
    tcfg = small(torch_config.load(settings_path(kind)), ds, kind)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = build_model(tcfg, CPU)
    assert model.preferred_staircase2 == (kind in FUSED)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    if not model.needs_graph():
        return ds, (jcfg, jmodel, jparams, None), \
            (tcfg, model, params, None)
    # gcn_diag built from gcn_basis.exp would get the fused layouts by
    # default and aggregate in XLA; staircase=True asks for kernel 3's
    # (the stored variant's graph keeps its edge order and has none).
    pad = -(-jmodel.graph_pad_bound(len(ds.train)) // 128) * 128
    jgraph = jmodel.make_graph(ds.train, pad_to=pad,
                               staircase=not jmodel.has_state)
    assert jmodel.has_state or jgraph.sc_fwd is not None
    return ds, (jcfg, jmodel, jparams, jgraph), \
        (tcfg, model, params, model.make_graph(ds.train))


def jax_noise(kind, name, key, deterministic=False):
    """The JAX encoder's draws besides the keep-masks under ``key``
    (``build.py:355-416``: random input at fold_in 23, the dropover choice
    at 29, the variational noise at 31, or 17 for the embedding), as the
    port's EncoderNoise; None for a configuration that draws none."""
    _, (jcfg, jmodel, _, _), (_, model, _, _) = case(kind, name)
    e = jcfg.encoder
    v, d = jcfg.entity_count, e.internal_dimension
    random_in = model.random_input or model.partially_random_input
    if not (random_in or jmodel.variational):
        return None

    def draw(a):
        return None if a is None else torch.from_numpy(np.array(a))
    fold = functools.partial(jax.random.fold_in, key)
    return EncoderNoise(
        random_input=draw(jax_init.uniform(fold(23), (v, d), -1.0, 1.0)
                          if random_in else None),
        dropover=draw(jax.random.uniform(fold(29), (v, d), minval=-1.0,
                                         maxval=1.0)
                      if model.partially_random_input and not deterministic
                      else None),
        eps=draw(jax.random.normal(
            fold(17 if e.name == "variational_embedding" else 31),
            (v, e.code_dimension)) if jmodel.variational else None))


def check_encode_and_scores(kind, name):
    """Test-mode codes and all-entity scores; JAX's test-mode noise
    (``PRNGKey(0)``) goes to the port where the encoder draws any."""
    ds, (_, jmodel, jparams, jgraph), (_, model, params, graph) = \
        case(kind, name)
    noise = jax_noise(kind, name, jax.random.PRNGKey(0), deterministic=True)
    want = jmodel.encode(jparams, jgraph, deterministic=True)
    got = model.encode(params, graph, deterministic=True, noise=noise)
    np.testing.assert_allclose(got.entity_codes.numpy(),
                               np.asarray(want.entity_codes), **TOL)
    scoring = model if noise is None else ModelView(model, noise)
    for fn in ("score_all_subjects", "score_all_objects"):
        want = np.asarray(getattr(jmodel, fn)(jparams, jgraph, ds.test))
        got = getattr(scoring, fn)(params, graph, ds.test)
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
    got = summary(Scorer(), ModelView(
        model, jax_noise(kind, name, jax.random.PRNGKey(0),
                         deterministic=True)),
        params, graph)
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
    noise = jax_noise(kind, name, key)
    got, grads = loss_and_grads(model, params, batch,
                                torch.from_numpy(values),
                                torch.from_numpy(co),
                                [torch.from_numpy(m) for m in masks],
                                *([] if noise is None else [noise]))
    return float(want), jgrads, float(got), grads


def check_loss_and_grads(kind, name, grad_atol=1e-6):
    """The loss within 1e-5 relative, every gradient leaf within rtol
    2e-4, atol ``grad_atol`` (1e-6: the dense layer's other rounding, as
    in tests/test_torch_basis_model.py); returns the port's gradients."""
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
                                   atol=grad_atol)
    return grads


def check_adam_steps(kind, name, max_near_zero=0.01):
    """See check_params_after_adam_steps (``max_near_zero``: the share of
    entries whose JAX gradient falls under 1e-6 at some step)."""
    _, (jcfg, _, jparams, _), (tcfg, _, _, _) = case(kind, name)
    jpipe, tpipe = pipelines(kind, name)
    check_params_after_adam_steps(jcfg, tcfg, jparams, jpipe, tpipe,
                                  functools.partial(both_steps, kind, name),
                                  max_near_zero)


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
    """The settings file of ``kind`` with its EXP_LINES, cut as ``small``
    cuts it, saving under tmp_path."""
    src = open(settings_path(kind)).read()
    enc = small(torch_config.load(settings_path(kind)),
                jax_dataset.load(TOY), kind).encoder
    for old, new in EXP_LINES[kind]:
        assert old in src, old
        src = src.replace(old, new)
    for key, value in (("CodeDimension", enc.code_dimension),
                       ("InternalEncoderDimension", enc.internal_dimension),
                       ("NumberOfBasisFunctions", enc.n_bases),
                       ("ExperimentName", tmp_path / "m")):
        src = re.sub(rf"(?m)^(\s*{key}=).*$", rf"\g<1>{value}", src)
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
        small(jax_config.load(settings_path(kind)), ds, kind).encoder)
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


def check_evaluate_cli_runs(tmp_path, capsys, kind):
    """The port's evaluate CLI on a JAX checkpoint of a configuration
    whose test-mode encode draws noise: it prints the step and the
    metrics (the port draws its own noise, so the values are not JAX's;
    check_encode_and_scores holds them to JAX's with JAX's noise)."""
    exp = small_exp(tmp_path, kind)
    ds = jax_dataset.load(TOY)
    cfg = jax_config.load(exp).with_counts(ds.n_entities, ds.n_relations,
                                           len(ds.train))
    params = jax_build(cfg).init_params(jax.random.PRNGKey(1))
    jax_ckpt.save(str(tmp_path / "m"), params=params,
                  opt_state=jax_optimizer(cfg.optimizer).init(params),
                  step=7, rng_key=jax.random.PRNGKey(2))
    capsys.readouterr()
    torch_evaluate.main(["--settings", exp, "--dataset", TOY, "--split",
                         "test", "--cpu"])
    printed = capsys.readouterr().out
    assert "(step 7)" in printed
    assert "MRR" in printed and "nan" not in printed.lower()


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
