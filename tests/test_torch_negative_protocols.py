"""The negative protocols through the port on the CPU against the JAX
package: the tiled loss (device-drawn and host-tiled), the split
protocol's loss_structured and the shared pool's loss_shared_negatives,
each with every gradient leaf, on gcn_block.exp (d=20, 2 layers) and on
distmult.exp / complex.exp (d=20); single_factor_negative_energies; the
device draws; the host-tiled batches bit for bit; the factored loss
against the tiled loss on matched draws; and a fit in every mode that
checks, saves and resumes bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationprediction_tpu.ops.neg_energy import (
    single_factor_negative_energies as jax_single_factor)
from relationprediction_tpu.training.device_sampling import (
    device_negative_sample as jax_negative_sample)
from relationprediction_tpu.training.engine import (
    BatchPipeline as JaxBatchPipeline)
from relationprediction_tpu.training.engine import TrainLoop as JaxTrainLoop
from relationprediction_torch.models.build import build_model
from relationprediction_torch.ops.neg_energy import (
    single_factor_negative_energies)
from relationprediction_torch.params import params_from_jax, tree_leaves
from relationprediction_torch.training import device_sampling as ds_lib
from relationprediction_torch.training.engine import (BatchPipeline, Draws,
                                                      TrainLoop, loss_kind,
                                                      step_loss_and_grads)

import test_torch_embedding_models as emb
import test_torch_train_step as block

CPU = torch.device("cpu")
# gcn_block on data/Toy (40-edge batches) and on the synthetic graph
# (600-edge batches); distmult and complex on the synthetic graph
# (600-positive minibatches): every batch is full, so the JAX package's
# split and shared CE masks are right on it (test_padding_...).
CASES = ["block-toy", "block-synthetic", "distmult", "complex"]
SIZES = {"block-toy": 40, "block-synthetic": 600}


def setup(name, padded=False):
    """(jcfg, jmodel, jparams, model, params, JAX pipeline, port pipeline)
    for one case; ``padded``: batches with padding rows (all 43 toy edges, or
    all 1,500 synthetic positives)."""
    if name.startswith("block"):
        data = name.split("-")[1]
        size = None if padded else SIZES[name]
        ds, (jcfg, jmodel, jparams), (tcfg, model) = block.case(data, size)
        jpipe, tpipe = block.pipelines(data, graph_batch_size=size)
    else:
        opt = {} if padded else {"batch_size": 600}
        ds, (jcfg, jmodel, jparams), (tcfg, model, _) = emb.case(
            name, "synthetic", **opt)
        jpipe, tpipe = emb.pipelines(name, "synthetic", **opt)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    return jcfg, jmodel, jparams, model, params, jpipe, tpipe


def keep_masks(jcfg, jmodel, model, positives, step):
    """JAX's key and the keep-masks its encoder draws with it."""
    key, _, _, masks = block.jax_draws(jcfg, jmodel, positives, step)
    return key, [torch.from_numpy(m) for m in masks] if model.is_gcn else []


def check_against_jax(jloss_fn, jparams, model, kind, params, batch, draws):
    want, jgrads = jax.value_and_grad(jloss_fn)(jparams)
    got, grads = step_loss_and_grads(model, kind, params, batch, draws)
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    for g, jg in zip(leaves, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=1e-6)
    assert any(g.abs().max() > 0 for g in leaves)
    return got, grads


def split_draws(n, rate, n_entities, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_entities, (n, rate // 2)).astype(np.int32),
            rng.integers(0, n_entities, (n, rate - rate // 2))
            .astype(np.int32))


def pool_draw(n_entities, size=24, seed=6):
    return np.random.default_rng(seed).integers(
        0, n_entities, size).astype(np.int32)


@pytest.mark.parametrize("name", CASES)
def test_device_tiled_loss_matches_jax(name):
    """``loss`` on device_negative_sample's tiled batch, JAX's draws."""
    jcfg, jmodel, jparams, model, params, jpipe, tpipe = setup(name)
    jb, tb = jpipe.next(), tpipe.next()
    key, masks = keep_masks(jcfg, jmodel, model, jb.triples, 0)
    triples, labels, mask = (np.array(a) for a in jax_negative_sample(
        jb.triples, jb.mask, jcfg.training.negative_sample_rate,
        jcfg.entity_count, jax.random.fold_in(key, 777)))

    def jloss(p):
        return jmodel.loss(p, jb.graph, triples, labels, mask, rng=key,
                           deterministic=False)
    draws = Draws(tuple(torch.from_numpy(a) for a in (triples, labels,
                                                      mask)), masks)
    check_against_jax(jloss, jparams, model, "tiled", params, tb, draws)


@pytest.mark.parametrize("name", ["block-toy", "block-synthetic",
                                  "distmult"])
def test_host_tiled_batches_equal_jax_and_train_alike(name):
    """BatchPipeline(device_negatives=False) gives the JAX package's
    host-tiled triples, labels and mask bit for bit (and its graphs), and
    the tiled loss on them matches JAX's."""
    jcfg, jmodel, jparams, model, params, _, _ = setup(name)
    tcfg = model.config
    if name.startswith("block"):
        data = block.case(name.split("-")[1], SIZES[name])[0]
    else:
        data = emb.case(name, "synthetic", batch_size=600)[0]
    jpipe = JaxBatchPipeline(jmodel, jcfg, data, np.random.default_rng(4),
                             device_negatives=False)
    tpipe = BatchPipeline(model, tcfg, data, np.random.default_rng(4),
                          device_negatives=False)
    rate = tcfg.training.negative_sample_rate
    for step in range(2):
        jb, tb = jpipe.next(), tpipe.next()
        assert tb.triples.shape[0] % 128 == 0
        assert tb.triples.shape[0] >= tpipe.n_positives * (rate + 1)
        np.testing.assert_array_equal(tb.triples.numpy(), jb.triples)
        np.testing.assert_array_equal(tb.labels.numpy(), jb.labels)
        np.testing.assert_array_equal(tb.mask.numpy(), jb.mask)
        if jb.graph is not None:
            assert tb.graph.fwd.n_edges == tpipe.split_size
    assert tpipe.state()["rng"] == jpipe.state()["rng"]
    key, masks = keep_masks(jcfg, jmodel, model, jb.triples, 1)

    def jloss(p):
        return jmodel.loss(p, jb.graph, jb.triples, jb.labels, jb.mask,
                           rng=key, deterministic=False)
    check_against_jax(jloss, jparams, model, "tiled", params, tb,
                      Draws((), masks))


@pytest.mark.parametrize("name", CASES)
def test_split_loss_matches_jax(name):
    jcfg, jmodel, jparams, model, params, jpipe, tpipe = setup(name)
    jb, tb = jpipe.next(), tpipe.next()
    assert jb.mask.min() == 1.0
    key, masks = keep_masks(jcfg, jmodel, model, jb.triples, 0)
    neg_s, neg_o = split_draws(len(jb.triples),
                               jcfg.training.negative_sample_rate,
                               jcfg.entity_count)

    def jloss(p):
        return jmodel.loss_structured(p, jb.graph, jb.triples, jb.mask,
                                      neg_s, neg_o, rng=key,
                                      deterministic=False)
    draws = Draws((torch.from_numpy(neg_s), torch.from_numpy(neg_o)), masks)
    check_against_jax(jloss, jparams, model, "split", params, tb, draws)


@pytest.mark.parametrize("name", CASES)
def test_shared_loss_matches_jax(name):
    jcfg, jmodel, jparams, model, params, jpipe, tpipe = setup(name)
    jb, tb = jpipe.next(), tpipe.next()
    assert jb.mask.min() == 1.0
    key, masks = keep_masks(jcfg, jmodel, model, jb.triples, 0)
    pool = pool_draw(jcfg.entity_count)

    def jloss(p):
        return jmodel.loss_shared_negatives(p, jb.graph, jb.triples,
                                            jb.mask, pool, rng=key,
                                            deterministic=False)
    draws = Draws((torch.from_numpy(pool),), masks)
    check_against_jax(jloss, jparams, model, "shared", params, tb, draws)


@pytest.mark.parametrize("kind", ["split", "shared"])
def test_padding_rows_count_for_nothing(kind):
    """On a batch with padding rows the port's split and shared losses
    (and gradients) equal the JAX package's on the real rows alone: each
    corruption group's CE mask follows its own positive. JAX tiles the
    mask over positive-major energies, which is right only on a full
    batch, so on the padded batch itself it gives another loss."""
    jcfg, jmodel, jparams, model, params, jpipe, tpipe = setup(
        "block-toy", padded=True)
    jb, tb = jpipe.next(), tpipe.next()
    n = int(jb.mask.sum())
    assert n < len(jb.mask)
    key, masks = keep_masks(jcfg, jmodel, model, jb.triples, 0)
    if kind == "split":
        neg = split_draws(len(jb.triples),
                          jcfg.training.negative_sample_rate,
                          jcfg.entity_count)
        real = tuple(a[:n] for a in neg)
        fn = "loss_structured"
    else:
        neg = real = (pool_draw(jcfg.entity_count),)
        fn = "loss_shared_negatives"

    def jloss(triples, mask, negs):
        return lambda p: getattr(jmodel, fn)(p, jb.graph, triples, mask,
                                             *negs, rng=key,
                                             deterministic=False)
    draws = Draws(tuple(torch.from_numpy(a) for a in neg), masks)
    got, _ = check_against_jax(jloss(jb.triples[:n], jb.mask[:n], real),
                               jparams, model, kind, params, tb, draws)
    quirk = float(jloss(jb.triples, jb.mask, neg)(jparams))
    assert abs(quirk - got.item()) > 1e-4 * abs(got.item())


@pytest.mark.parametrize("n,k,d", [(7, 5, 12), (33, 4, 20)])
def test_single_factor_negative_energies_match_jax(n, k, d):
    rng = np.random.default_rng(n)
    codes = rng.standard_normal((40, d)).astype(np.float32)
    q = rng.standard_normal((n, d)).astype(np.float32)
    neg = rng.integers(0, 40, (n, k)).astype(np.int32)
    d_e = rng.standard_normal((n, k)).astype(np.float32)
    d_s = rng.standard_normal((n, k)).astype(np.float32)
    (want_e, want_s), vjp = jax.vjp(
        lambda c, f: jax_single_factor(c, f, jnp.asarray(neg)), codes, q)
    want_dc, want_dq = vjp((d_e, d_s))
    tc, tq = (torch.from_numpy(a).requires_grad_(True) for a in (codes, q))
    got_e, got_s = single_factor_negative_energies(tc, tq,
                                                   torch.from_numpy(neg))
    np.testing.assert_allclose(got_e.detach().numpy(), want_e, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.detach().numpy(), want_s, rtol=1e-5)
    dc, dq = torch.autograd.grad(
        (got_e * torch.from_numpy(d_e)).sum()
        + (got_s * torch.from_numpy(d_s)).sum(), (tc, tq))
    np.testing.assert_allclose(dc.numpy(), want_dc, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=2e-4, atol=1e-5)


def test_device_negative_sample_corrupts_as_the_parts_do():
    """One generator state: the tiled batch's row j*n + i is positive i's
    copy j with the corruption that device_negative_parts gives at [i, j];
    positives first with their mask as labels, the mask tiled."""
    rng = np.random.default_rng(0)
    n, rate, v = 13, 4, 50
    positives = torch.from_numpy(rng.integers(0, v, (n, 3)).astype(np.int32))
    mask = torch.ones(n)
    mask[-2:] = 0.0
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    values, co = ds_lib.device_negative_parts(positives, rate, v, gen)
    gen.set_state(state)
    triples, labels, tmask = ds_lib.device_negative_sample(
        positives, mask, rate, v, gen)
    assert triples.shape == (n * (rate + 1), 3)
    assert triples.dtype == torch.int32
    assert torch.equal(triples[:n], positives)
    assert torch.equal(labels, torch.cat([mask, torch.zeros(n * rate)]))
    assert torch.equal(tmask, mask.repeat(rate + 1))
    neg = triples[n:].view(rate, n, 3).transpose(0, 1)  # [n, rate, 3]
    base = positives[:, None, :].expand(n, rate, 3)
    assert torch.equal(neg[..., 1], base[..., 1])
    assert torch.equal(torch.where(co, neg[..., 2], neg[..., 0]), values)
    assert torch.equal(torch.where(co, neg[..., 0], neg[..., 2]),
                       torch.where(co, base[..., 0], base[..., 2]))


def test_split_and_pool_draws():
    gen = torch.Generator().manual_seed(1)
    positives = torch.zeros((12, 3), dtype=torch.int32)
    for rate in (10, 7):
        s, o = ds_lib.device_negative_entities_split(positives, rate, 30,
                                                     gen)
        assert s.shape == (12, rate // 2) and o.shape == (12, rate - rate // 2)
        assert s.dtype == o.dtype == torch.int32
        assert 0 <= int(s.min()) and int(max(s.max(), o.max())) < 30
    state = gen.get_state()
    pool = ds_lib.device_negative_pool(512, 30, gen)
    assert pool.shape == (512,) and pool.dtype == torch.int32
    assert len(pool.unique()) == 30
    gen.set_state(state)
    assert torch.equal(ds_lib.device_negative_pool(512, 30, gen), pool)


@pytest.mark.parametrize("name", CASES)
def test_factored_loss_equals_tiled_loss_on_matched_draws(name):
    """The factored binomial loss equals the tiled loss on the tiled
    batch of the same generator state, gradients included."""
    _, _, _, model, params, _, tpipe = setup(name)
    batch = tpipe.next()
    cfg = model.config
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    args = (cfg.training.negative_sample_rate, cfg.entity_count, gen)
    factored = Draws(ds_lib.device_negative_parts(batch.triples, *args),
                     model.draw_keep_masks(gen))
    gen.set_state(state)
    tiled = Draws(ds_lib.device_negative_sample(batch.triples, batch.mask,
                                                *args),
                  model.draw_keep_masks(gen))
    want, wgrads = step_loss_and_grads(model, "factored", params, batch,
                                       factored)
    got, grads = step_loss_and_grads(model, "tiled", params, batch, tiled)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    for g, w in zip(tree_leaves(grads), tree_leaves(wgrads)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("decoder", ["bilinear-diag", "complex",
                                     "nonlinear-transform"])
def test_loss_kind_follows_the_jax_rule(decoder):
    """The objective per (decoder, mode, device negatives) is the JAX
    TrainLoop's."""
    ds, (jcfg, jmodel, _), (tcfg, _) = block.case("toy")
    jcfg, tcfg = (dataclasses.replace(c, decoder=dataclasses.replace(
        c.decoder, name=decoder, decoder_dimension=8, embedding_width=20))
        for c in (jcfg, tcfg))
    jmodel = type(jmodel)(jcfg)
    model = build_model(tcfg, CPU)
    for mode in ("binomial", "split", "shared"):
        for device_negatives in (True, False):
            jl = JaxTrainLoop(jmodel, jcfg, ds, prefetch=False,
                              log=lambda line: None, negative_mode=mode,
                              device_negatives=device_negatives)
            want = ("factored" if jl._use_factored_binomial
                    else "split" if jl._use_structured
                    else "shared" if jl._use_shared else "tiled")
            kind = loss_kind(model, mode, device_negatives)
            assert kind == want, (mode, device_negatives)
            loop = TrainLoop(model, tcfg, ds, prefetch=False,
                             log=lambda line: None, negative_mode=mode,
                             device_negatives=device_negatives)
            assert loop.loss_kind == kind
            assert loop.pipeline.device_negatives == device_negatives
    with pytest.raises(ValueError, match="negative mode"):
        loss_kind(model, "tiled", True)


FIT_MODES = {
    "split": dict(negative_mode="split"),
    "shared": dict(negative_mode="shared", negative_pool_size=16),
    "tiled": dict(negative_mode="binomial", decoder="nonlinear-transform"),
    "host-tiled": dict(device_negatives=False),
    "factored": dict(negative_mode="binomial"),
}


@pytest.mark.parametrize("mode", sorted(FIT_MODES))
def test_fit_checks_saves_and_resumes_bit_for_bit(tmp_path, mode):
    """gcn_block (d=20) on data/Toy, 2 prefetch threads, a check and a
    save every 2 steps: 8 steps straight against 4 and a resume to 8 in a
    new loop give the same batches, losses, params and optimizer state bit
    for bit, and the checks the same scores."""
    kw = dict(FIT_MODES[mode])
    decoder = kw.pop("decoder", None)
    ds, _, (tcfg, model) = block.case("toy")
    tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, early_stopping_check_every=2,
        early_stopping_burnin=100))
    if decoder:
        tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(
            tcfg.decoder, name=decoder, decoder_dimension=8,
            embedding_width=20))
    model = build_model(tcfg, CPU)
    want_kind = "tiled" if mode == "host-tiled" else mode

    def recording_loop(path):
        scores = []

        def score(params):
            scores.append(float(params["relation_embedding"]["W_relation"]
                                .sum()))
            return -len(scores)  # falling, but inside the burn-in
        loop = TrainLoop(model, tcfg, ds, seed=2, log=lambda line: None,
                         scoring_function=score, **kw)
        assert loop.loss_kind == want_kind
        seen, step = [], loop.train_step

        def train_step(params, opt_state, batch):
            seen.append(batch.triples.numpy().copy())
            return step(params, opt_state, batch)
        loop.train_step = train_step
        return loop, seen, scores

    loop, straight, scores = recording_loop(tmp_path / "a")
    params, opt_state = loop.init_state(0)
    whole = loop.fit(params, opt_state, max_iterations=8,
                     checkpoint_path=str(tmp_path / "a"))
    loop, _, _ = recording_loop(tmp_path / "b")
    params, opt_state = loop.init_state(0)
    loop.fit(params, opt_state, max_iterations=4,
             checkpoint_path=str(tmp_path / "b"))
    loop, resumed, tail_scores = recording_loop(tmp_path / "b")
    tail = loop.resume(str(tmp_path / "b"), max_iterations=8)
    assert not torch.are_deterministic_algorithms_enabled()
    assert whole.iterations == tail.iterations == 8
    assert len(scores) == 4 and tail_scores == scores[2:]
    assert len(resumed) == 4
    for a, b in zip(straight[4:], resumed):
        np.testing.assert_array_equal(a, b)
    assert [s["loss"] for s in whole.steps[4:]] == \
        [s["loss"] for s in tail.steps]
    assert all(np.isfinite(s["loss"]) for s in whole.steps)
    for a, b in zip(tree_leaves(whole.params), tree_leaves(tail.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(whole.opt_state),
                    tree_leaves(tail.opt_state)):
        assert torch.equal(a, b)
    if mode == "host-tiled":
        rate = tcfg.training.negative_sample_rate
        assert len(straight[0]) % 128 == 0
        assert len(straight[0]) >= loop.pipeline.n_positives * (rate + 1)
