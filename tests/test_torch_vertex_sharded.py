"""The port's vertex-sharded path (relationprediction_torch/parallel/
vertex_sharded.py) on gloo groups of 2 and 4 CPU ranks, against the JAX
package's VertexShardedEncoder on as many of conftest's virtual CPU devices
(tests/test_vertex_sharded.py; its Pallas ops run in interpret mode there), at
Toy with d = 16 and 4 bases, from JAX's initial params and with JAX's
keep-masks ('full_parity'), at the JAX package's tolerances: the host layouts
and batches bit for bit; the encode of gcn_block, gcn_basis and gcn_diag with
both halo modes; the tiled and factored losses and their gradients, overlapped
and sequential; then, against the port's one-device step and view: the entity
table's gradient through a mean over the ranks and a clip without the
all-reduce as the controls that must fail, the evaluation view (also against
JAX's view), and TrainLoop(vertex_sharded=True) (two runs equal bit for bit,
the loss falls, a resumed run equal to the straight one).

Each group is one ``distributed.launch`` of ``_rank_checks`` (spawned
processes, one torch thread each), whose rank 0 returns every number the
tests compare."""
import dataclasses
import functools
import hashlib
import os

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.models import build_model as jax_build
from relationprediction_tpu.parallel import make_mesh as jax_make_mesh
from relationprediction_tpu.parallel import vertex_sharded as jvs
from relationprediction_torch import config as torch_config
from relationprediction_torch.data import dataset as torch_dataset
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.graph import build_graph_batch
from relationprediction_torch.models.build import ModelView, build_model
from relationprediction_torch.parallel import distributed
from relationprediction_torch.parallel import vertex_sharded as vs
from relationprediction_torch.parallel.collectives import pmean
from relationprediction_torch.parallel.mesh import EdgeMesh
from relationprediction_torch.params import (map_tree, params_from_jax,
                                             tree_leaves)
from relationprediction_torch.sampling import NegativeSampler
from relationprediction_torch.training.engine import (Draws, TrainBatch,
                                                      TrainLoop,
                                                      _value_and_grad,
                                                      step_loss_and_grads)
from relationprediction_torch.training.optimizers import (apply_updates,
                                                          build_optimizer)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOY = os.path.join(ROOT, "data", "Toy")
CPU = torch.device("cpu")
WORLDS = (2, 4)
PADDED = 3   # ranks that pad Toy's 16 entities to 18 table rows
KEY = 7      # JAX's loss key, PRNGKey(KEY): its keep-masks
RATE = 3     # corruptions a positive in the factored batch
# (settings file, encoder changes) of each configuration.
MODELS = {"block": ("gcn_block", {}), "basis": ("gcn_basis", {}),
          "diag": ("gcn_basis", {"name": "gcn_diag"})}
HALOS = ("targeted", "all_gather")
# (label, loss kind, VertexShardedEncoder options) of the loss cells; each
# is held to JAX's sequential targeted loss.
LOSSES = (("block", "factored", {}), ("block", "factored", {"overlap": True}),
          ("block", "factored", {"halo": "all_gather"}),
          ("basis", "tiled", {}), ("basis", "tiled", {"overlap": True}),
          ("diag", "factored", {}))
# The JAX package's tolerances (tests/test_vertex_sharded.py).
CODES = dict(rtol=2e-4, atol=2e-5)
LOSS_RTOL = 2e-4
GRADS = dict(rtol=5e-4, atol=1e-5)


def settings(exp):
    return os.path.join(ROOT, "settings", f"{exp}.exp")


def cut(cfg, ds, encoder=(), **optimizer):
    """A settings file at d = 16 with 4 bases (blocks of 4x4)."""
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, code_dimension=16,
                                    internal_dimension=16, n_bases=4,
                                    **dict(encoder)),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=16),
        optimizer=dataclasses.replace(cfg.optimizer, **optimizer),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


@functools.lru_cache(maxsize=None)
def jax_case(label):
    ds = jax_dataset.load(TOY)
    exp, encoder = MODELS[label]
    model = jax_build(cut(jax_config.load(settings(exp)), ds,
                          encoder.items()))
    return ds, model, model.init_params(jax.random.PRNGKey(0))


def loss_inputs():
    """The tiled batch (x, y) and the factored one (positives, values,
    corrupt) of Toy's train set, drawn from seed 0."""
    ds = jax_dataset.load(TOY)
    pos = np.asarray(ds.train, dtype=np.int32)
    x, y = NegativeSampler(2, ds.n_entities,
                           np.random.default_rng(0)).transform(pos)
    rng = np.random.default_rng(0)
    vals = rng.integers(0, ds.n_entities, (len(pos), RATE)).astype(np.int32)
    return {"tiled": (x, y),
            "factored": (pos, vals, rng.random((len(pos), RATE)) < 0.5)}


def jax_keep_masks(label):
    """The [V, d] keep-masks JAX's 'full_parity' encode draws from
    PRNGKey(KEY) (``vertex_sharded.py:677-679``)."""
    _, model, _ = jax_case(label)
    e = model.config.encoder
    key = jax.random.PRNGKey(KEY)
    return [np.array(jax.random.bernoulli(
        jax.random.fold_in(key, 100 + layer), e.dropout_keep_probability,
        (model.n_entities, e.internal_dimension)))
        for layer in range(e.n_layers)]


def jax_vse(label, n, **kw):
    _, model, _ = jax_case(label)
    return jvs.VertexShardedEncoder(model, jax_make_mesh(n), **kw)


@functools.lru_cache(maxsize=None)
def jax_codes(label, halo, n):
    ds, _, params = jax_case(label)
    enc = jax_vse(label, n, halo=halo)
    f, b = enc.prepare(ds.train, pad_to=64)
    return np.asarray(enc.encode_fn()(enc.pad_params(params), f, b))


@functools.lru_cache(maxsize=None)
def jax_loss(label, kind, n):
    """(loss, gradient leaves) of JAX's sequential targeted loss."""
    ds, _, params = jax_case(label)
    enc = jax_vse(label, n, dropout_mode="full_parity")
    f, b = enc.prepare(ds.train, pad_to=64)
    inputs = loss_inputs()[kind]
    if kind == "factored":
        fn, batch = enc.loss_fn_factored(), enc.prepare_batch_factored(
            *inputs)
    else:
        fn, batch = enc.loss_fn(), enc.prepare_batch(*inputs)
    loss, grads = jax.jit(jax.value_and_grad(fn))(
        enc.pad_params(params), f, b, *batch, jax.random.PRNGKey(KEY))
    return float(loss), [np.asarray(g)
                         for g in jax.tree_util.tree_leaves(grads)]


@functools.lru_cache(maxsize=None)
def jax_view(n):
    """JAX's VertexShardedModelView of gcn_basis on n devices: the
    validation triples' scores and filtered MRR (JAX's Scorer, chunks of
    7)."""
    from relationprediction_tpu.evaluation.scorer import Scorer as JaxScorer
    ds, _, params = jax_case("basis")
    enc = jax_vse("basis", n)
    view = jvs.VertexShardedModelView(enc, *enc.prepare(ds.train, pad_to=64),
                                      chunk_pad=8)
    out = {"objects": view.score_all_objects(params, None, ds.valid,
                                             apply_sigmoid=False),
           "subjects": view.score_all_subjects(params, None, ds.valid),
           "score": view.score(params, None, ds.valid)}
    scorer = JaxScorer(metric="MRR", chunk_size=7)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    scorer.register_model(view, params, None, n_entities=ds.n_entities)
    scorer.finalize_frequency_computation(ds.all_triples())
    out["mrr"] = scorer.compute_scores(ds.valid).results["Filtered"]["MRR"]
    return out


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def port_case(label, **optimizer):
    ds = torch_dataset.load(TOY)
    exp, encoder = MODELS[label]
    cfg = cut(torch_config.load(settings(exp)), ds, encoder.items(),
              **optimizer)
    return ds, cfg, build_model(cfg, CPU)


def numpy_leaves(tree):
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def digest(*trees):
    h = hashlib.sha256()
    for tree in trees:
        for t in tree_leaves(tree):
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_batch(enc, ds, kind, inputs):
    """(this rank's batch, the VSBatch of every shard) of ``kind``."""
    f, b = enc.prepare(ds.train, pad_to=64)
    if kind == "factored":
        xt, mt, vt, ct, send, e1, e2, ev = enc.prepare_batch_factored(
            *inputs["factored"])
        batch = vs.VSBatch(f, b, xt, None, mt, send, e1, e2, vt, ct, ev)
    else:
        xt, yt, mt, send, e1, e2 = enc.prepare_batch(*inputs["tiled"])
        batch = vs.VSBatch(f, b, xt, yt, mt, send, e1, e2)
    return vs.VSRankBatch(enc.shard_graph(f, b), enc.shard_loss(batch)), \
        batch


def local_state(enc, jparams):
    return enc.place_state(enc.pad_params(params_from_jax(jparams, CPU)))


def codes_of(mesh, label, halo, jparams):
    """The padded [v_pad, d] test-mode codes, gathered from the ranks."""
    ds, _, model = port_case(label)
    enc = vs.VertexShardedEncoder(model, mesh, halo=halo)
    f, b = enc.prepare(ds.train, pad_to=64)
    with torch.no_grad():
        codes = enc.local_encode(local_state(enc, jparams),
                                 enc.shard_graph(f, b))
    return enc.gather_state({"input_transform": {"W": codes}})[
        "input_transform"]["W"].numpy()


def loss_of(mesh, label, kind, options, jparams, masks, inputs):
    ds, _, model = port_case(label)
    enc = vs.VertexShardedEncoder(model, mesh, dropout_mode="full_parity",
                                  **options)
    batch, _ = rank_batch(enc, ds, kind, inputs)
    loss, grads = enc.loss_and_grads(
        local_state(enc, jparams), batch,
        enc.shard_keep_masks([torch.from_numpy(m) for m in masks]))
    return {"loss": loss.item(),
            "grads": numpy_leaves(enc.gather_state(grads))}


def controls(mesh, jparams, masks, inputs):
    """gcn_block's factored step: the table's gradient through the mean
    over the ranks of the whole tree (``pmean``); and one SGD step at lr 1
    whose clip is active, with the global sum of squares, with the
    table's local sum alone (no all-reduce), and (rank 0) the one-device
    step on the same batch and keep-masks."""
    ds, cfg, model = port_case("block", algorithm="GradientDescent",
                               learning_rate=1.0, max_gradient_norm=0.05)
    enc = vs.VertexShardedEncoder(model, mesh, dropout_mode="full_parity")
    batch, whole = rank_batch(enc, ds, "factored", inputs)
    local = local_state(enc, jparams)
    keep = enc.shard_keep_masks([torch.from_numpy(m) for m in masks])
    _, raw = _value_and_grad(
        lambda: enc.loss(local, batch.graph, batch.loss, keep), local)
    out = {"pmean_table": enc.gather_state(pmean(raw, mesh.group))[
        "input_transform"]["W"].numpy()}
    opt = build_optimizer(cfg.optimizer)
    out["before"] = numpy_leaves(params_from_jax(jparams, CPU))
    for name, fn in (("global_clip", enc.sum_of_squares(raw)),
                     ("local_clip", None)):
        p = map_tree(torch.clone, local)
        _, grads = enc.loss_and_grads(p, batch, keep)
        if name == "global_clip":
            out["norm"] = float(fn(tree_leaves(grads)).sqrt())
        updates, _ = opt.update(grads, opt.init(p), sum_of_squares=fn)
        apply_updates(p, updates)
        out[name] = numpy_leaves(enc.unpad_params(enc.gather_state(p)))
    if mesh.rank == 0:
        params = params_from_jax(jparams, CPU)
        one = TrainBatch(build_graph_batch(ds.train, ds.n_entities,
                                           ds.n_relations),
                         torch.from_numpy(whole.triples.reshape(-1, 3)),
                         torch.from_numpy(whole.mask.reshape(-1)))
        draws = Draws((torch.from_numpy(whole.neg_values.reshape(-1, RATE)),
                       torch.from_numpy(
                           whole.corrupt_object.reshape(-1, RATE))),
                      [torch.from_numpy(m) for m in masks])
        _, grads = step_loss_and_grads(model, "factored", params, one, draws)
        updates, _ = opt.update(grads, opt.init(params))
        apply_updates(params, updates)
        out["one_device"] = numpy_leaves(params)
    return out


def view_parity(mesh, jparams):
    """VertexShardedModelView and the one-device ModelView on gcn_basis
    from JAX's initial params: scores of the validation triples and the
    filtered MRR (chunks of 7)."""
    ds, _, model = port_case("basis")
    params = params_from_jax(jparams, CPU)
    enc = vs.VertexShardedEncoder(model, mesh)
    views = (("sharded", vs.VertexShardedModelView(
                 enc, *vs.eval_arrays(enc, ds.train)), None),
             ("one", ModelView(model), model.make_graph(ds.train)))
    out = {}
    for name, view, graph in views:
        out[f"{name}_objects"] = view.score_all_objects(
            params, graph, ds.valid, apply_sigmoid=False).numpy()
        out[f"{name}_subjects"] = view.score_all_subjects(
            params, graph, ds.valid).numpy()
        out[f"{name}_score"] = view.score(params, graph, ds.valid).numpy()
        scorer = Scorer(metric="MRR", chunk_size=7)
        for t in (ds.train, ds.valid, ds.test):
            scorer.register_data(t)
        scorer.register_degrees(ds.train)
        scorer.register_model(view, params, graph, n_entities=ds.n_entities)
        scorer.finalize_frequency_computation(ds.all_triples())
        out[f"{name}_mrr"] = scorer.compute_scores(
            ds.valid).results["Filtered"]["MRR"]
    return out


def loop_runs(mesh, out_dir):
    """TrainLoop(vertex_sharded=True) on gcn_block (factored, per-shard
    dropout): two 8-step runs at one seed; then a run cut at step 4, saved
    there, and resumed to 8 (rank 0 writes the checkpoints)."""
    ds, cfg, model = port_case("block", learning_rate=0.05, save_every_n=4)
    runs = {}

    def loop():
        return TrainLoop(model, cfg, ds, seed=3, prefetch=False,
                         log=lambda m: None, mesh=mesh, vertex_sharded=True)
    for name in ("a", "b"):
        result = loop().fit(max_iterations=8)
        runs[name] = {"losses": [s["loss"] for s in result.steps],
                      "digest": digest(result.params, result.opt_state),
                      "rows": int(result.params["input_transform"]["W"]
                                  .shape[0])}
    path = os.path.join(out_dir, "m")
    loop().fit(max_iterations=4, checkpoint_path=path)
    resumed = loop().resume(path, max_iterations=8)
    runs["resumed"] = digest(resumed.params, resumed.opt_state)
    return runs


def _rank_checks(mesh, jax_inputs, inputs, out_dir):
    torch.set_num_threads(1)
    params = {label: jax_inputs[label][0] for label in MODELS}
    out = {"codes": {(label, halo): codes_of(mesh, label, halo,
                                             params[label])
                     for label in MODELS for halo in HALOS},
           "losses": [loss_of(mesh, label, kind, options, params[label],
                              jax_inputs[label][1], inputs)
                      for label, kind, options in LOSSES],
           "controls": controls(mesh, params["block"],
                                jax_inputs["block"][1], inputs),
           "view": view_parity(mesh, params["basis"]),
           "loop": loop_runs(mesh, out_dir)}
    if mesh.rank:  # the other ranks send only what is held to rank 0's
        out = {"loop": out["loop"]}
    return out


def _padded_checks(mesh, jax_inputs, inputs, out_dir):
    """gcn_block's encode, factored loss and loop on a padded table."""
    torch.set_num_threads(1)
    params, masks = jax_inputs["block"]
    out = {"codes": codes_of(mesh, "block", "targeted", params),
           "loss": loss_of(mesh, "block", "factored", {}, params, masks,
                           inputs),
           "loop": loop_runs(mesh, out_dir)}
    return out if mesh.rank == 0 else {"loop": out["loop"]}


def launch_checks(fn, n, tmp_path_factory):
    jax_inputs = {label: (jax.tree_util.tree_map(np.asarray,
                                                 jax_case(label)[2]),
                          jax_keep_masks(label)) for label in MODELS}
    out_dir = str(tmp_path_factory.mktemp(f"vs{n}"))
    return n, distributed.launch(fn, n, (jax_inputs, loss_inputs(), out_dir),
                                 cpu=True, timeout=300)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def ranks(request, tmp_path_factory):
    return launch_checks(_rank_checks, request.param, tmp_path_factory)


# ---------------------------------------------------------------------------
# Against the JAX package's vertex-sharded encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("label", tuple(MODELS))
def test_encode_matches_jax(ranks, label, halo):
    n, results = ranks
    got = results[0]["codes"][(label, halo)]
    np.testing.assert_allclose(got, jax_codes(label, halo, n), **CODES)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("cell", range(len(LOSSES)),
                         ids=[f"{label}-{kind}-{'-'.join(opt) or 'seq'}"
                              for label, kind, opt in LOSSES])
def test_loss_and_grads_match_jax(ranks, cell):
    """Both losses with JAX's keep-masks ('full_parity'), sequential,
    overlapped and all-gathered, against JAX's sequential targeted loss:
    every leaf, the padded entity table's included."""
    n, results = ranks
    label, kind, _ = LOSSES[cell]
    got = results[0]["losses"][cell]
    want_loss, want_grads = jax_loss(label, kind, n)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
    assert len(got["grads"]) == len(want_grads)
    for g, w in zip(got["grads"], want_grads):
        np.testing.assert_allclose(g, w, **GRADS)


# ---------------------------------------------------------------------------
# The gradient rules, the view and the loop
# ---------------------------------------------------------------------------

def test_table_gradient_through_pmean_misses(ranks):
    """The entity table's rows differ from rank to rank: a mean over the
    ranks of the whole gradient tree averages different vertices' rows,
    and misses JAX's gradient that the reduced one matches."""
    n, results = ranks
    table = 8  # input_transform/W among gcn_block's leaves
    want = jax_loss("block", "factored", n)[1][table]
    np.testing.assert_allclose(results[0]["losses"][0]["grads"][table],
                               want, **GRADS)
    bad = results[0]["controls"]["pmean_table"]
    assert np.abs(bad - want).max() > 100 * GRADS["atol"]


def test_clip_needs_the_tables_all_reduce(ranks):
    """An SGD step whose clip is active follows the one-device step with
    the global sum of squares, and misses it where the table's sum of
    squares skips the all-reduce."""
    _, results = ranks
    c = results[0]["controls"]
    assert c["norm"] > 0.05 * 10

    def update_rel_l2(got):
        """The update's relative L2 distance from the one-device one's."""
        diff = sum(float(((g - w).astype(np.float64) ** 2).sum())
                   for g, w in zip(got, c["one_device"]))
        norm = sum(float(((w - b).astype(np.float64) ** 2).sum())
                   for w, b in zip(c["one_device"], c["before"]))
        return (diff / norm) ** 0.5
    for g, w in zip(c["global_clip"], c["one_device"]):
        np.testing.assert_allclose(g, w, **GRADS)
    assert update_rel_l2(c["global_clip"]) <= 1e-4
    assert update_rel_l2(c["local_clip"]) > 1e-2


def test_sharded_view_matches_jax(ranks):
    """The port's VertexShardedModelView against JAX's on as many virtual
    devices, from the same params: the all-reduce of owned rows, the
    all-gather of score blocks, the cut to V."""
    n, results = ranks
    v, want = results[0]["view"], jax_view(n)
    for part in ("objects", "subjects", "score"):
        assert v[f"sharded_{part}"].shape == want[part].shape
        np.testing.assert_allclose(v[f"sharded_{part}"], want[part], **CODES)
    np.testing.assert_allclose(v["sharded_mrr"], want["mrr"], rtol=1e-5)


def test_sharded_view_matches_one_device_view(ranks):
    _, results = ranks
    v = results[0]["view"]
    for part in ("objects", "subjects", "score"):
        assert v[f"sharded_{part}"].shape == v[f"one_{part}"].shape
        np.testing.assert_allclose(v[f"sharded_{part}"], v[f"one_{part}"],
                                   **CODES)
    np.testing.assert_allclose(v["sharded_mrr"], v["one_mrr"], rtol=1e-5)


def test_trainloop_runs_equal_learn_and_resume(ranks):
    """Two runs at one seed give the same padded params and Adam state bit
    for bit on every rank; the loss falls; a run resumed from its step-4
    checkpoint ends as the straight run."""
    check_loop_runs(*ranks)


def test_padded_table_matches_jax_and_trains(tmp_path_factory):
    """3 ranks pad the 16-entity table to 18 rows: the encode and the
    factored loss's gradients (the padding rows' zero) against JAX's, and
    the loop's runs, as on 2 and 4 ranks."""
    n, results = launch_checks(_padded_checks, PADDED, tmp_path_factory)
    got = results[0]
    assert got["codes"].shape == (18, 16)
    np.testing.assert_allclose(got["codes"],
                               jax_codes("block", "targeted", n), **CODES)
    want_loss, want_grads = jax_loss("block", "factored", n)
    np.testing.assert_allclose(got["loss"]["loss"], want_loss,
                               rtol=LOSS_RTOL)
    for g, w in zip(got["loss"]["grads"], want_grads):
        np.testing.assert_allclose(g, w, **GRADS)
    assert not got["loss"]["grads"][8][16:].any()  # the padding rows
    check_loop_runs(n, results)


def check_loop_runs(n, results):
    runs = [r["loop"] for r in results]
    assert len({r["a"]["digest"] for r in runs}
               | {r["b"]["digest"] for r in runs}
               | {r["resumed"] for r in runs}) == 1
    a = runs[0]["a"]
    assert a["losses"] == runs[0]["b"]["losses"]
    assert np.all(np.isfinite(a["losses"]))
    assert a["losses"][-1] < a["losses"][0]
    assert a["rows"] == -(-16 // n) * n


# ---------------------------------------------------------------------------
# Host layouts and batches, bit for bit; the rules
# ---------------------------------------------------------------------------

def host_pair(n, label="block", **training):
    """(JAX encoder, port encoder) of ``label`` on n shards; the port's
    on a mesh record without a group (no collective runs)."""
    ds = torch_dataset.load(TOY)
    exp, encoder = MODELS[label]
    cfg = cut(torch_config.load(settings(exp)), ds, encoder.items())
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, **training))
    jds, jmodel, _ = jax_case(label)
    jcfg = dataclasses.replace(jmodel.config, training=dataclasses.replace(
        jmodel.config.training, **training))
    return (jvs.VertexShardedEncoder(jax_build(jcfg), jax_make_mesh(n)),
            vs.VertexShardedEncoder(build_model(cfg, CPU),
                                    EdgeMesh(0, n, None, CPU, "gloo")),
            (jds, jcfg), (ds, cfg))


def jax_host(arrays):
    """The JAX package's host arrays without the TPU slot layouts that
    its fused encoder appends to a direction's 7 arrays."""
    if isinstance(arrays, jvs.VSBatch):
        return arrays._replace(f_arrays=arrays.f_arrays[:7],
                               b_arrays=arrays.b_arrays[:7])
    return tuple(a[:7] for a in arrays)


def same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or isinstance(w, tuple):
            assert (g is None) == (w is None)
            if w is not None:
                same_arrays(g, w)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", WORLDS)
def test_host_layouts_equal_jax(n):
    ds = jax_dataset.load(TOY)
    triples = np.asarray(ds.train)
    for pad in (64, 96):
        f, b, rows = vs.partition_edges_by_destination(
            triples, ds.n_entities, n, pad, ds.n_relations)
        jf, jb, jrows = jvs.partition_edges_by_destination(
            triples, ds.n_entities, n, pad, ds.n_relations)
        same_arrays(f, jf)
        same_arrays(b, jb)
        assert rows == jrows
    rng = np.random.default_rng(n)
    src = rng.integers(0, ds.n_entities + 1, (n, 40)).astype(np.int32)
    msk = (rng.random((n, 40)) > 0.2).astype(np.float32)
    for budget in (None, 24):
        layout, ptr = vs.build_halo(src, msk, rows, n, ds.n_entities,
                                    h_budget=budget)
        jlayout, jptr = jvs.build_halo(src, msk, rows, n, ds.n_entities,
                                       h_budget=budget)
        same_arrays((layout.send_idx, ptr), (jlayout.send_idx, jptr))
        assert layout.h == jlayout.h
        assert vs.halo_traffic_rows(layout, rows, n) \
            == jvs.halo_traffic_rows(jlayout, rows, n)
    jenc, enc, _, _ = host_pair(n)
    same_arrays(enc.prepare(triples, 64),
                jax_host(jenc.prepare(triples, 64)))
    inputs = loss_inputs()
    same_arrays(enc.prepare_batch(*inputs["tiled"]),
                jenc.prepare_batch(*inputs["tiled"]))
    same_arrays(enc.prepare_batch_factored(*inputs["factored"], t_pad=48),
                jenc.prepare_batch_factored(*inputs["factored"], t_pad=48))


@pytest.mark.parametrize("factored", (True, False), ids=("factored", "tiled"))
def test_pipeline_batches_equal_jax(factored):
    """The pipeline's budgets (probed from 0xB0D6E7) and batches from one
    seed, and its state and set_state, equal the JAX package's."""
    jenc, enc, (jds, jcfg), (ds, cfg) = host_pair(2, graph_batch_size=20)
    jpipe = jvs.VertexShardedBatchPipeline(
        jenc, jcfg, jds, np.random.default_rng(5), factored=factored)
    pipe = vs.VertexShardedBatchPipeline(
        enc, cfg, ds, np.random.default_rng(5), factored=factored)
    assert pipe.budgets == jpipe.budgets
    for _ in range(2):
        same_arrays(pipe.next(), jax_host(jpipe.next()))
    state = pipe.state()
    assert state == jpipe.state()
    want = jax_host(jpipe.next())
    pipe.next()
    pipe.set_state(state)
    same_arrays(pipe.next(), want)


def test_rank_batch_holds_its_shard():
    """shard_rank gives a rank's CSRs and slices: its real edges, each
    targeted at an owned row and reading the halo pointer of its source."""
    _, enc, _, (ds, cfg) = host_pair(2, graph_batch_size=20)
    whole = vs.VertexShardedBatchPipeline(enc, cfg, ds,
                                          np.random.default_rng(5),
                                          factored=True).next()
    mine = vs.VertexShardedBatchPipeline(enc, cfg, ds,
                                         np.random.default_rng(5),
                                         factored=True, shard_rank=1).next()
    sen, rel, rec, msk, nrm, send, ptr = whole.f_arrays
    csr = mine.graph.fwd.csr
    assert csr.n_rows == enc.rows_per
    assert csr.source_rows == 2 * send.shape[-1] + enc.rows_per
    assert csr.n_edges == int(msk[1].sum())
    real = msk[1] > 0
    got = sorted(zip(np.repeat(np.arange(enc.rows_per),
                               np.diff(csr.row_ptr.numpy())).tolist(),
                     csr.src.tolist(), csr.rel.tolist()))
    want = sorted(zip((rec[1][real] - enc.rows_per).tolist(),
                      ptr[1][real].tolist(), rel[1][real].tolist()))
    assert got == want
    twin = mine.graph.fwd.twin
    assert twin.n_rows == csr.source_rows and twin.source_rows == enc.rows_per
    np.testing.assert_array_equal(mine.loss.e1_ptr.numpy(), whole.e1_ptr[1])
    np.testing.assert_array_equal(mine.graph.fwd.send_idx.numpy(), send[1])


def test_halo_budget_overflow_raises():
    """A boundary over its budget raises, as in the JAX package (no
    redraw), in prepare, in the loss batch and in the pipeline."""
    jenc, enc, (jds, jcfg), (ds, cfg) = host_pair(4)
    triples = np.asarray(ds.train)
    f, _ = enc.prepare(triples, pad_to=64, halo_budget=16)
    assert f[5].shape[-1] == 16
    for e in (enc, jenc):
        with pytest.raises(ValueError, match="halo budget"):
            e.prepare(triples, pad_to=64, halo_budget=0)
        with pytest.raises(ValueError, match="halo budget"):
            e.prepare_batch(*loss_inputs()["tiled"], halo_budget=0)
    budgets = {"edge_pad": 64, "halo_budget": 8, "dec_halo_budget": 0,
               "t_pad": 480}
    with pytest.raises(ValueError, match="halo budget"):
        vs.VertexShardedBatchPipeline(enc, cfg, ds, np.random.default_rng(0),
                                      budgets=budgets).next()


def test_unsupported_configurations_raise():
    """Each of the JAX package's rules raises in both packages."""
    ds = torch_dataset.load(TOY)
    mesh = EdgeMesh(0, 2, None, CPU, "gloo")
    jds, jmodel, _ = jax_case("block")
    _, cfg, model = port_case("block")
    for change in ({"skip_connections": "Highway"},
                   {"use_input_transform": False},
                   {"name": "variational_gcn_basis"},
                   {"store_edge_data": True}):
        bad = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, **change))
        with pytest.raises(ValueError, match="supports the dense-input"):
            vs.VertexShardedEncoder(build_model(bad, CPU), mesh)
    for kw, what in (({"halo": "bogus"}, "halo mode"),
                     ({"dropout_mode": "bogus"}, "dropout_mode"),
                     ({"overlap": True, "halo": "all_gather"},
                      "overlap requires")):
        with pytest.raises(ValueError, match=what):
            vs.VertexShardedEncoder(model, mesh, **kw)
        with pytest.raises(ValueError, match=what):
            jvs.VertexShardedEncoder(jmodel, jax_make_mesh(2), **kw)
    _, _, diag = port_case("diag")
    assert not vs.VertexShardedEncoder(diag, mesh).fused
    assert vs.VertexShardedEncoder(model, mesh).fused
    assert not vs.VertexShardedEncoder(model, mesh, overlap=True).fused
    with pytest.raises(ValueError, match="requires a mesh"):
        TrainLoop(model, cfg, ds, vertex_sharded=True)
    with pytest.raises(ValueError, match="binomial"):
        TrainLoop(model, cfg, ds, mesh=mesh, vertex_sharded=True,
                  negative_mode="split")
