"""The port's edge-partitioned step (relationprediction_torch/parallel/
mesh.py) on gloo groups of 2 and 4 CPU ranks, against the JAX package's
mesh step on as many of conftest's virtual CPU devices and against its
one-device step (tests/test_parallel.py, test_staircase2_mesh.py,
test_factored_binomial.py::test_mesh_factored_binomial): gcn_block,
gcn_basis and distmult at d = 16 on data/Toy, from JAX's initial params
on the same host-tiled batch and keep-masks. Then, against the port's
one-process step on explicit draws: the factored, split and shared
protocols, plain SGD with a sum of the gradients in place of their mean as
the control that must fail, params equal bit for bit on every rank after
3 Adam steps, a graph whose weights were counted over a shard as the
control that must fail, the sharded ModelView and TrainLoop(mesh=).

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
from relationprediction_tpu.parallel import mesh as jax_mesh
from relationprediction_tpu.training import BatchPipeline as JaxPipeline
from relationprediction_tpu.training.optimizers import (
    build_optimizer as jax_optimizer)
from relationprediction_torch import config as torch_config
from relationprediction_torch.data import dataset as torch_dataset
from relationprediction_torch.graph import build_graph_batch, shard_edges
from relationprediction_torch.models.build import ModelView, build_model
from relationprediction_torch.parallel import distributed
from relationprediction_torch.parallel.collectives import pmean
from relationprediction_torch.parallel.mesh import EdgeMesh, shard_rows
from relationprediction_torch.params import (map_tree, params_from_jax,
                                             tree_leaves)
from relationprediction_torch.training import device_sampling
from relationprediction_torch.training.engine import (
    BatchPipeline, Draws, TrainLoop, make_sharded_train_step,
    sharded_loss_and_grads, step_loss_and_grads, step_seed)
from relationprediction_torch.training.optimizers import (apply_updates,
                                                          build_optimizer)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOY = os.path.join(ROOT, "data", "Toy")
CPU = torch.device("cpu")
MODELS = ("gcn_block", "gcn_basis", "distmult")
PROTOCOLS = ("factored", "split", "shared")
WORLDS = (2, 4)
KEY = 7          # JAX's step key, PRNGKey(KEY): its keep-masks
DRAW_SEED = 5    # the explicit draws of the protocol checks
POOL = 16
# The JAX package's own mesh tolerances (tests/test_parallel.py:70-75).
LOSS_RTOL, LEAF_RTOL, LEAF_ATOL = 2e-5, 2e-4, 2e-5


def settings(exp):
    return os.path.join(ROOT, "settings", f"{exp}.exp")


def cut(cfg, ds, **optimizer):
    """A settings file at d = 16 with 4 bases (blocks of 4x4)."""
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, code_dimension=16,
                                    internal_dimension=16, n_bases=4),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=16),
        optimizer=dataclasses.replace(cfg.optimizer, **optimizer),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))


@functools.lru_cache(maxsize=None)
def jax_case(exp):
    ds = jax_dataset.load(TOY)
    jcfg = cut(jax_config.load(settings(exp)), ds)
    model = jax_build(jcfg)
    return ds, jcfg, model, model.init_params(jax.random.PRNGKey(0))


def jax_keep_masks(exp):
    """The keep-masks JAX's encoder draws from PRNGKey(KEY)."""
    ds, jcfg, model, _ = jax_case(exp)
    if not model.needs_graph():
        return []
    e = jcfg.encoder
    key = jax.random.PRNGKey(KEY)
    return [np.array(jax.random.bernoulli(
        jax.random.fold_in(key, 100 + layer), e.dropout_keep_probability,
        (jcfg.entity_count, e.internal_dimension)))
        for layer in range(e.n_layers)]


def jax_batch(exp, n):
    ds, jcfg, model, _ = jax_case(exp)
    return JaxPipeline(model, jcfg, ds, np.random.default_rng(0),
                       device_negatives=False, shard_multiple=n).next()


@functools.lru_cache(maxsize=None)
def jax_one_device(exp):
    """(loss, gradient leaves) of JAX's one-device tiled loss."""
    _, _, model, params = jax_case(exp)
    b = jax_batch(exp, 1)
    loss, grads = jax.value_and_grad(lambda p: model.loss(
        p, b.graph, b.triples, b.labels, b.mask,
        rng=jax.random.PRNGKey(KEY), deterministic=False))(params)
    return float(loss), [np.asarray(g)
                         for g in jax.tree_util.tree_leaves(grads)]


@functools.lru_cache(maxsize=None)
def jax_mesh_step(exp, n):
    """(loss, param leaves) after JAX's sharded Adam step on n devices."""
    _, jcfg, model, params = jax_case(exp)
    opt = jax_optimizer(jcfg.optimizer)
    mesh = jax_mesh.make_mesh(n)
    step = jax_mesh.make_sharded_train_step(model, opt, mesh,
                                            has_graph=model.needs_graph())
    b = jax_batch(exp, n)
    g, t, y, m = jax_mesh.shard_batch(mesh, b.graph, b.triples, b.labels,
                                      b.mask)
    p, _, loss = step(jax_mesh.replicate(mesh, params),
                      jax_mesh.replicate(mesh, opt.init(params)), g, t, y,
                      m, jax.random.PRNGKey(KEY))
    return float(loss), [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def torch_case(exp, **optimizer):
    ds = torch_dataset.load(TOY)
    cfg = cut(torch_config.load(settings(exp)), ds, **optimizer)
    return ds, cfg, build_model(cfg, CPU)


def numpy_leaves(tree):
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def digest(*trees):
    h = hashlib.sha256()
    for tree in trees:
        for t in tree_leaves(tree):
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def jax_parity(mesh, exp, jparams, masks):
    """The sharded tiled step from JAX's params, batch and keep-masks:
    loss and gradients, then the params after one Adam step."""
    ds, cfg, model = torch_case(exp)
    params = params_from_jax(jparams, CPU)
    batch = BatchPipeline(model, cfg, ds, np.random.default_rng(0),
                          device_negatives=False,
                          shard_multiple=mesh.world_size,
                          shard_rank=mesh.rank).next()
    draws = Draws((), [torch.from_numpy(m) for m in masks])
    loss, grads = sharded_loss_and_grads(model, "tiled", params, batch,
                                         draws, mesh)
    opt = build_optimizer(cfg.optimizer)
    step = make_sharded_train_step(model, opt, mesh, "tiled")
    step(params, opt.init(params), batch, draws)
    return {"loss": loss.item(), "grads": numpy_leaves(grads),
            "params": numpy_leaves(params)}


def global_draws(model, cfg, kind, triples, n_rows):
    """Draws for the whole batch of ``n_rows`` positives from one seeded
    generator: negatives of every row, keep-masks for all ranks."""
    gen = torch.Generator().manual_seed(DRAW_SEED)
    rate, v = cfg.training.negative_sample_rate, cfg.entity_count
    if kind == "factored":
        neg = device_sampling.device_negative_parts(triples, rate, v, gen)
    elif kind == "split":
        neg = device_sampling.device_negative_entities_split(triples, rate,
                                                             v, gen)
    else:
        neg = (device_sampling.device_negative_pool(POOL, v, gen),)
    return Draws(tuple(neg), model.draw_keep_masks(gen))


def rank_draws(draws, kind, shard):
    """This rank's rows of the negatives (the shared pool whole), the
    keep-masks as they are."""
    if kind == "shared":
        return draws
    rows = shard_rows(draws.negatives[0].shape[0], shard)
    return draws._replace(negatives=tuple(x[rows] for x in draws.negatives))


def batches(mesh, model, cfg, ds, device_negatives=True):
    """(this rank's batch, the global batch with the whole graph) of the
    same pipeline seed."""
    kw = dict(device_negatives=device_negatives,
              shard_multiple=mesh.world_size)
    mine = BatchPipeline(model, cfg, ds, np.random.default_rng(0),
                         shard_rank=mesh.rank, **kw).next()
    whole = BatchPipeline(model, cfg, ds, np.random.default_rng(0),
                          **kw).next()
    return mine, whole


def protocol_parity(mesh, kind):
    """The sharded loss of ``kind`` on gcn_block against the one-process
    loss on the global batch and the same draws."""
    ds, cfg, model = torch_case("gcn_block")
    params = model.init_params(torch.Generator().manual_seed(0))
    mine, whole = batches(mesh, model, cfg, ds)
    draws = global_draws(model, cfg, kind, whole.triples,
                         whole.triples.shape[0])
    loss, grads = sharded_loss_and_grads(
        model, kind, params, mine, rank_draws(draws, kind, mesh.shard), mesh)
    ref_loss, ref_grads = step_loss_and_grads(model, kind, params, whole,
                                              draws)
    return {"loss": loss.item(), "grads": numpy_leaves(grads),
            "ref_loss": ref_loss.item(), "ref_grads": numpy_leaves(ref_grads)}


def sgd_parity(mesh):
    """One SGD step at lr 1 without clipping, sharded and one-process, and
    the control that sums the ranks' gradients in place of their mean."""
    ds, cfg, model = torch_case("gcn_block", algorithm="GradientDescent",
                                max_gradient_norm=None, learning_rate=1.0)
    opt = build_optimizer(cfg.optimizer)
    params = model.init_params(torch.Generator().manual_seed(0))
    mine, whole = batches(mesh, model, cfg, ds)
    draws = global_draws(model, cfg, "factored", whole.triples,
                         whole.triples.shape[0])
    sharded = map_tree(torch.clone, params)
    make_sharded_train_step(model, opt, mesh, "factored")(
        sharded, opt.init(sharded), mine,
        rank_draws(draws, "factored", mesh.shard))
    _, local = step_loss_and_grads(model, "factored", params, mine,
                                   rank_draws(draws, "factored", mesh.shard),
                                   group=mesh.group)
    summed = map_tree(lambda g: g * mesh.world_size,
                      pmean(local, mesh.group))
    out = {"sharded": numpy_leaves(sharded)}
    for name, grads in (("summed", summed), ("one_process", None)):
        p = map_tree(torch.clone, params)
        if grads is None:
            _, grads = step_loss_and_grads(model, "factored", p, whole,
                                           draws)
        updates, _ = opt.update(grads, opt.init(p))
        apply_updates(p, updates)
        out[name] = numpy_leaves(p)
    return out


def adam_replicas(mesh, steps=3):
    """Digests of the params and Adam state after ``steps`` sharded steps
    on successive batches."""
    ds, cfg, model = torch_case("gcn_block")
    opt = build_optimizer(cfg.optimizer)
    params = model.init_params(torch.Generator().manual_seed(0))
    state = opt.init(params)
    pipe = BatchPipeline(model, cfg, ds, np.random.default_rng(0),
                         shard_multiple=mesh.world_size,
                         shard_rank=mesh.rank)
    step = make_sharded_train_step(model, opt, mesh, "factored")
    for i in range(steps):
        batch = pipe.next()
        rows = torch.Generator().manual_seed(step_seed(0, 777, i, mesh.rank))
        shared = torch.Generator().manual_seed(step_seed(0, 778, i))
        neg = device_sampling.device_negative_parts(
            batch.triples, cfg.training.negative_sample_rate,
            cfg.entity_count, rows)
        state, _ = step(params, state, batch,
                        Draws(neg, model.draw_keep_masks(shared)))
    return {"digest": digest(params, state), "count": int(state["count"])}


def shard_local_control(mesh):
    """The factored loss with this rank's shard weighted over its own
    edges (a degree counted over a shard) against the one-process loss."""
    ds, cfg, model = torch_case("gcn_block")
    params = model.init_params(torch.Generator().manual_seed(0))
    pipe = BatchPipeline(model, cfg, ds, np.random.default_rng(0),
                         shard_multiple=mesh.world_size)
    _, split_ids = pipe.sample_ids()
    edges = pipe.train[split_ids]
    mine, whole = batches(mesh, model, cfg, ds)
    local = build_graph_batch(
        edges[shard_edges(len(edges), mesh.shard)], ds.n_entities,
        ds.n_relations)
    local = dataclasses.replace(local, shard=mesh.shard)
    draws = global_draws(model, cfg, "factored", whole.triples,
                         whole.triples.shape[0])
    mine_draws = rank_draws(draws, "factored", mesh.shard)
    good, _ = sharded_loss_and_grads(model, "factored", params, mine,
                                     mine_draws, mesh)
    bad, _ = sharded_loss_and_grads(model, "factored", params,
                                    mine._replace(graph=local), mine_draws,
                                    mesh)
    ref, _ = step_loss_and_grads(model, "factored", params, whole, draws)
    return {"good": good.item(), "bad": bad.item(), "ref": ref.item()}


def view_parity(mesh):
    """The sharded ModelView's scores and filtered MRR against the one-device
    view's (chunks of 7, ragged against the ranks)."""
    from relationprediction_torch.evaluation.scorer import Scorer
    ds, cfg, model = torch_case("gcn_basis")
    params = model.init_params(torch.Generator().manual_seed(1))
    out = {}
    for name, view, graph in (
            ("one", ModelView(model), model.make_graph(ds.train)),
            ("mesh", ModelView(model, mesh=mesh),
             model.make_graph(ds.train, shard=mesh.shard))):
        out[f"{name}_objects"] = view.score_all_objects(
            params, graph, ds.valid, apply_sigmoid=False).numpy()
        out[f"{name}_subjects"] = view.score_all_subjects(
            params, graph, ds.valid).numpy()
        scorer = Scorer(metric="MRR", chunk_size=7)
        for t in (ds.train, ds.valid, ds.test):
            scorer.register_data(t)
        scorer.register_degrees(ds.train)
        scorer.register_model(view, params, graph, n_entities=ds.n_entities)
        scorer.finalize_frequency_computation(ds.all_triples())
        out[f"{name}_mrr"] = scorer.compute_scores(
            ds.valid).results["Filtered"]["MRR"]
    return out


def loop_losses(mesh, steps=4):
    """TrainLoop(mesh=) on host-tiled batches for ``steps`` steps."""
    ds, cfg, model = torch_case("gcn_basis")
    loop = TrainLoop(model, cfg, ds, seed=7, prefetch=False,
                     device_negatives=False, log=lambda m: None, mesh=mesh)
    result = loop.fit(max_iterations=steps)
    return {"losses": [s["loss"] for s in result.steps],
            "params": numpy_leaves(result.params),
            "digest": digest(result.params, result.opt_state)}


def rel_l2(a, b):
    a, b = a.double(), b.double()
    norm = b.norm().item()
    return (a - b).norm().item() / norm if norm else (a - b).norm().item()


def per_block_step(model, kind, params, whole, draws, n):
    """(loss, gradient tree): the mean over n equal blocks of the global
    batch's rows of the one-process step on each block with the whole
    graph. Each block's means divide by its own count, n times smaller
    than the batch's (every row real), so its gradient is n times its
    rows' share, as on a rank: the mesh's step without a collective."""
    rows_of = [shard_rows(whole.triples.shape[0], (r, n)) for r in range(n)]
    assert all(whole.mask[rows].sum() * n == whole.mask.sum()
               for rows in rows_of)
    losses, trees = [], []
    for rows in rows_of:
        loss, grads = step_loss_and_grads(
            model, kind, params,
            whole._replace(triples=whole.triples[rows],
                           mask=whole.mask[rows]),
            draws._replace(negatives=tuple(x[rows]
                                           for x in draws.negatives)))
        losses.append(loss)
        trees.append(tree_leaves(grads))
    return sum(losses) / n, [sum(leaves) / n for leaves in zip(*trees)]


def bf16_parity(mesh):
    """gcn_block with bf16 message precision, and with bf16 message and
    stream precision, on a 1,100-entity synthetic graph (hub entities with
    dozens of rows a batch): the sharded factored step and the one-process
    step against each other and against the f32 step, leaf by leaf."""
    from relationprediction_torch.data import synthetic
    ds = synthetic.generate(1100, 11, 6000, 50, 50, seed=0)
    base = torch_config.load(settings("gcn_block"))
    base = dataclasses.replace(base, training=dataclasses.replace(
        base.training, graph_batch_size=4000))
    out, f32 = {}, None
    for label, message, stream in (("f32", "float32", "float32"),
                                   ("message", "bfloat16", "float32"),
                                   ("both", "bfloat16", "bfloat16")):
        cfg = dataclasses.replace(cut(base, ds), encoder=dataclasses.replace(
            cut(base, ds).encoder, message_precision=message),
            decoder=dataclasses.replace(cut(base, ds).decoder,
                                        stream_precision=stream))
        model = build_model(cfg, CPU)
        params = model.init_params(torch.Generator().manual_seed(0))
        mine, whole = batches(mesh, model, cfg, ds)
        draws = global_draws(model, cfg, "factored", whole.triples,
                             whole.triples.shape[0])
        mine_draws = rank_draws(draws, "factored", mesh.shard)
        loss, grads = sharded_loss_and_grads(model, "factored", params,
                                             mine, mine_draws, mesh)
        ref_loss, ref_grads = step_loss_and_grads(model, "factored", params,
                                                  whole, draws)
        if f32 is None:
            f32 = ref_grads
        if label == "both":
            # Faulty sharded steps: the gradients summed in place of their
            # mean, and rank 0's alone (the other ranks' rows lost).
            _, alone = step_loss_and_grads(model, "factored", params, mine,
                                           mine_draws, group=mesh.group)
            block_loss, block_grads = per_block_step(
                model, "factored", params, whole, draws, mesh.world_size)
            out["blocks"] = {
                name: {"loss_rel": abs(value.item() - block_loss.item())
                       / abs(block_loss.item()),
                       "leaves": [rel_l2(a, b) for a, b in zip(
                           tree_leaves(tree), block_grads)]}
                for name, value, tree in (
                    ("mesh", loss, grads),
                    ("summed", loss, map_tree(
                        lambda g: g * mesh.world_size, grads)),
                    ("rank0_alone", loss, alone))}
        out[label] = {
            "loss_rel": abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()),
            "vs_one": [rel_l2(a, b) for a, b in zip(tree_leaves(grads),
                                                    tree_leaves(ref_grads))],
            "vs_f32": [rel_l2(a, b) for a, b in zip(tree_leaves(grads),
                                                    tree_leaves(f32))],
            "one_vs_f32": [rel_l2(a, b) for a, b in zip(
                tree_leaves(ref_grads), tree_leaves(f32))]}
    return out


def draw_streams(mesh):
    """Digests of a mesh loop's first step's draws: the negatives of this
    rank's rows, and the keep-masks every rank shares."""
    ds, cfg, model = torch_case("gcn_block")
    loop = TrainLoop(model, cfg, ds, seed=3, prefetch=False, mesh=mesh)
    loop.seed_step(1)
    draws = loop.draw(loop.pipeline.next())
    return {"negatives": digest(list(draws.negatives)),
            "keep_masks": digest([m.to(torch.uint8)
                                  for m in draws.keep_masks])}


def _rank_checks(mesh, jax_inputs):
    torch.set_num_threads(1)
    out = {"parity": {exp: jax_parity(mesh, exp, *jax_inputs[exp])
                      for exp in MODELS},
           "protocols": {kind: protocol_parity(mesh, kind)
                         for kind in PROTOCOLS},
           "sgd": sgd_parity(mesh), "adam": adam_replicas(mesh),
           "control": shard_local_control(mesh), "view": view_parity(mesh),
           "loop": loop_losses(mesh), "draws": draw_streams(mesh),
           "bf16": bf16_parity(mesh)}
    if mesh.rank:  # the other ranks send only what is held to rank 0's
        out = {"adam": out["adam"], "loop": {"digest": out["loop"]["digest"]},
               "draws": out["draws"]}
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def ranks(request):
    n = request.param
    jax_inputs = {exp: (jax.tree_util.tree_map(np.asarray, jax_case(exp)[3]),
                        jax_keep_masks(exp)) for exp in MODELS}
    return n, distributed.launch(_rank_checks, n, (jax_inputs,), cpu=True,
                                 timeout=300)


def close_leaves(got, want, rtol=LEAF_RTOL, atol=LEAF_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exp", MODELS)
def test_sharded_step_matches_jax_one_device_step(ranks, exp):
    n, results = ranks
    got = results[0]["parity"][exp]
    want_loss, want_grads = jax_one_device(exp)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
    close_leaves(got["grads"], want_grads)
    assert any(np.abs(g).max() > 0 for g in got["grads"])


@pytest.mark.parametrize("exp", MODELS)
def test_sharded_step_matches_jax_mesh_step(ranks, exp):
    """Loss and params after one Adam step against JAX's
    make_sharded_train_step on as many virtual devices."""
    n, results = ranks
    got = results[0]["parity"][exp]
    want_loss, want_params = jax_mesh_step(exp, n)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
    close_leaves(got["params"], want_params)


@pytest.mark.parametrize("kind", PROTOCOLS)
def test_protocols_match_one_process_step(ranks, kind):
    """The factored, split and shared losses: each rank's rows and their
    negatives, the keep-masks and the pool shared."""
    _, results = ranks
    got = results[0]["protocols"][kind]
    np.testing.assert_allclose(got["loss"], got["ref_loss"], rtol=LOSS_RTOL)
    close_leaves(got["grads"], got["ref_grads"])


def test_sgd_step_is_scale_sensitive(ranks):
    """Plain SGD at lr 1 follows the one-process step, and the sum of the
    ranks' gradients (each N times its share) in place of their mean
    misses it: the check that Adam's scale invariance would hide."""
    n, results = ranks
    sgd = results[0]["sgd"]
    close_leaves(sgd["sharded"], sgd["one_process"])
    worst = max(np.abs(a - b).max() / (LEAF_ATOL + LEAF_RTOL * np.abs(b).max())
                for a, b in zip(sgd["summed"], sgd["one_process"]))
    assert worst > 10, worst


def test_replicated_params_equal_bit_for_bit_after_adam(ranks):
    n, results = ranks
    digests = {r["adam"]["digest"] for r in results}
    assert len(results) == n and len(digests) == 1
    assert results[0]["adam"]["count"] == 3


def test_shard_local_weights_fail_parity(ranks):
    """Weights from the whole batch match the one-process loss; weights
    counted over each shard (the control) do not."""
    _, results = ranks
    c = results[0]["control"]
    np.testing.assert_allclose(c["good"], c["ref"], rtol=LOSS_RTOL)
    assert abs(c["bad"] - c["ref"]) > 100 * LOSS_RTOL * abs(c["ref"])


def test_sharded_model_view_matches_one_device(ranks):
    _, results = ranks
    v = results[0]["view"]
    for part in ("objects", "subjects"):
        assert v[f"mesh_{part}"].shape == v[f"one_{part}"].shape
        np.testing.assert_allclose(v[f"mesh_{part}"], v[f"one_{part}"],
                                   rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(v["mesh_mrr"], v["one_mrr"], rtol=1e-5)


def test_trainloop_on_mesh_matches_one_device_loop(ranks):
    """TrainLoop(mesh=) against the one-device TrainLoop on the same
    host-tiled batches and keep-masks (its generator seeded as the mesh
    seeds its shared one, every step); the ranks end equal bit for bit."""
    n, results = ranks
    ds, cfg, model = torch_case("gcn_basis")
    loop = TrainLoop(model, cfg, ds, seed=7, prefetch=False,
                     device_negatives=False, log=lambda m: None)
    step, calls = loop.train_step, []

    def seeded_step(params, opt_state, batch):
        calls.append(1)
        loop.generator.manual_seed(step_seed(7, 778, len(calls)))
        return step(params, opt_state, batch)
    loop.train_step = seeded_step
    want = loop.fit(max_iterations=4)
    got = results[0]["loop"]
    np.testing.assert_allclose(got["losses"], [s["loss"] for s in want.steps],
                               rtol=5e-4, atol=1e-6)
    close_leaves(got["params"], numpy_leaves(want.params), rtol=5e-3,
                 atol=5e-5)
    assert len({r["loop"]["digest"] for r in results}) == 1


def test_bf16_messages_match_and_bf16_streams_stay_as_close_to_f32(ranks):
    """bf16 message precision (the bf16 kernels, f32 sums) matches the
    one-process step within the card's bf16 step rule (loss 1e-4, each
    leaf 1e-2 in relative L2). On bf16 streams the positives' gathers sum
    their backward serially in bf16 (the reference's arithmetic), so a
    rank's half of a hub's rows rounds otherwise than the whole: the
    leaves may move from the one-process step by up to the bf16 error
    itself, and each is held instead to stay as close to the f32 step as
    the one-process bf16 step is (1.5x + 1e-6, the bf16 op tests' rule),
    with the loss within 1e-4. They are held to the bf16 step rule against
    the mean of the one-process steps on each rank's block of rows, which
    sum in bf16 as the ranks do; a sum of the ranks' gradients in place of
    their mean, and rank 0's gradient alone, must miss that."""
    _, results = ranks
    b = results[0]["bf16"]
    assert b["f32"]["loss_rel"] <= LOSS_RTOL
    assert b["message"]["loss_rel"] <= 1e-4
    assert max(b["message"]["vs_one"]) <= 1e-2
    assert b["both"]["loss_rel"] <= 1e-4
    for mesh_err, one_err in zip(b["both"]["vs_f32"],
                                 b["both"]["one_vs_f32"]):
        assert mesh_err <= 1.5 * one_err + 1e-6
    # The bf16 streams do move the leaves, and the rule catches a faulty
    # sharded step.
    assert max(b["both"]["one_vs_f32"]) > 1e-3
    # Against the one-process step on each rank's block of rows (the
    # mesh's sums in bf16, without a collective): the bf16 step rule; the
    # controls miss it.
    blocks = b["blocks"]
    assert blocks["mesh"]["loss_rel"] <= 1e-4
    assert max(blocks["mesh"]["leaves"]) <= 1e-2
    assert max(blocks["summed"]["leaves"]) > 1e-2
    assert max(blocks["rank0_alone"]["leaves"]) > 1e-2


def test_ranks_draw_their_own_negatives_and_shared_masks(ranks):
    """Each rank's corruptions come from its own stream (seed, step,
    rank); the keep-masks from the one every rank shares."""
    n, results = ranks
    assert len({r["draws"]["negatives"] for r in results}) == n
    assert len({r["draws"]["keep_masks"] for r in results}) == 1


@pytest.mark.parametrize("n", WORLDS)
def test_graph_shards_hold_the_batch_with_global_weights(n):
    """The union of the shards' edges is the batch, each edge once, and
    every shard's weights are the whole graph's."""
    ds, cfg, model = torch_case("gcn_block")
    edges = np.asarray(ds.train, dtype=np.int64)
    whole = build_graph_batch(edges, ds.n_entities, ds.n_relations)

    def keyed(layout, order, w):
        return {int(o): float(x) for o, x in zip(order.numpy(), w.numpy())}
    want_f = keyed(whole.fwd, whole.fwd_order, whole.fwd.w)
    want_b = keyed(whole.bwd, whole.bwd_order, whole.bwd.w)
    got_f, got_b = {}, {}
    for rank in range(n):
        g = build_graph_batch(edges, ds.n_entities, ds.n_relations,
                              shard=(rank, n))
        assert g.shard == (rank, n) and g.fwd.n_rows == ds.n_entities
        block = shard_edges(len(edges), (rank, n))
        assert sorted(g.fwd_order.tolist()) == list(range(block.start,
                                                          block.stop))
        for got, layout, order in ((got_f, g.fwd, g.fwd_order),
                                   (got_b, g.bwd, g.bwd_order)):
            part = keyed(layout, order, layout.w)
            assert not set(part) & set(got)
            got.update(part)
        tgt = np.repeat(np.arange(ds.n_entities), np.diff(g.fwd.row_ptr))
        np.testing.assert_array_equal(
            np.stack([g.fwd.src.numpy(), g.fwd.rel.numpy(), tgt], 1),
            edges[g.fwd_order.numpy()][:, [0, 1, 2]])
    assert got_f == want_f and got_b == want_b


def test_stored_variant_raises_on_a_mesh():
    ds = torch_dataset.load(TOY)
    cfg = cut(torch_config.load(settings("gcn_basis")), ds)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, store_edge_data=True))
    model = build_model(cfg, CPU)
    assert model.has_state
    mesh = EdgeMesh(0, 2, None, CPU, "gloo")
    loop = TrainLoop(model, cfg, ds, prefetch=False, mesh=mesh)
    params, opt_state = loop.init_state()
    with pytest.raises(ValueError, match="stored-message"):
        loop.train_step(params, opt_state, loop.pipeline.next())
