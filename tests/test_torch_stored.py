"""The stored-message variant (gcn_basis.exp with StoreEdgeData=Yes,
BasisGcnStore) through the port on the CPU against the JAX package. Each
train step sums only the delta between the batch edges' fresh basis
messages and their cached ones, with unit weights, through
staircase_aggregate (TPU kernel 3), adds the cached vertex state and
writes the caches back. Three steps of ``loss_stateful`` with the caches
carried: loss, every gradient leaf and every cache against JAX's; the
test-mode encode (basis messages summed with 'none' weights), scores and
ranks; the host-tiled batches with the message graph's edge ids;
TrainLoop's fit, with and without prefetch threads; zero caches after a
resume (caches are not checkpointed, in the JAX package neither); the
train CLI."""
import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu.training.engine import (
    BatchPipeline as JaxBatchPipeline)
from relationprediction_torch.params import params_from_jax, tree_leaves
from relationprediction_torch.training.engine import (BatchPipeline, Draws,
                                                      TrainLoop,
                                                      stateful_loss_and_grads)

from test_torch_onehot_model import (CPU, case,
                                     check_checkpoint_and_evaluate_cli,
                                     check_encode_and_scores, check_ranks,
                                     check_train_cli, check_trees)
from test_torch_train_step import jax_draws

KIND = "stored"


def pipelines(name, seed=0):
    ds, (jcfg, jmodel, _, _), (tcfg, model, _, _) = case(KIND, name)
    return (JaxBatchPipeline(jmodel, jcfg, ds, np.random.default_rng(seed),
                             device_negatives=True),
            BatchPipeline(model, tcfg, ds, np.random.default_rng(seed)))


@pytest.mark.parametrize("name", ["toy", "synthetic"])
def test_batches_are_host_tiled_with_the_edge_ids(name):
    """Device negatives are off for a model with state (JAX
    ``engine.py:91``): the same host-tiled triples, labels and mask as
    JAX's, and the split's global edge ids as a tensor (JAX pads them with
    the phantom row; the port's graph has no padding edges)."""
    ds, _, (_, model, _, _) = case(KIND, name)
    assert model.has_state
    jpipe, tpipe = pipelines(name)
    assert not tpipe.device_negatives and not jpipe.device_negatives
    for _ in range(2):
        jb, tb = jpipe.next(), tpipe.next()
        np.testing.assert_array_equal(tb.triples.numpy(), jb.triples)
        np.testing.assert_array_equal(tb.labels.numpy(), jb.labels)
        np.testing.assert_array_equal(tb.mask.numpy(), jb.mask)
        n = len(tb.edge_ids)
        np.testing.assert_array_equal(tb.message_edge_ids.numpy(),
                                      jb.edge_ids[:n])
        assert (np.asarray(jb.edge_ids[n:]) == len(ds.train)).all()
        assert tb.message_edge_ids.dtype == torch.int64
        assert any(t is tb.message_edge_ids for t in tb.tensors())


@pytest.mark.parametrize("name", ["toy", "synthetic"])
def test_three_stateful_steps_match_jax(name):
    """loss_stateful three times from zero caches, each step's caches fed
    to the next, on three batches with JAX's keep-masks: the loss within
    1e-5 relative, every gradient leaf within rtol 2e-4 and atol 1e-6 of
    its largest entry, every cache within rtol 1e-5 and atol 1e-5 of its
    largest entry (sums of unnormalized messages)."""
    _, (jcfg, jmodel, jparams, _), (_, model, _, _) = case(KIND, name)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             CPU)
    jpipe, tpipe = pipelines(name)
    jstate, state = jmodel.init_cache_state(), model.init_cache_state()
    for step in range(3):
        jb, tb = jpipe.next(), tpipe.next()
        key, _, _, masks = jax_draws(jcfg, jmodel, jb.triples, step)

        def jloss(p, st=jstate):
            return jmodel.loss_stateful(p, st, jb.graph, jb.edge_ids,
                                        jb.triples, jb.labels, jb.mask,
                                        rng=key)
        (want, jstate), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            jparams)
        got, grads, state = stateful_loss_and_grads(
            model, params, state, tb,
            Draws((), [torch.from_numpy(m) for m in masks]))
        assert np.isfinite(got.item())
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        for g, jg in zip(tree_leaves(grads),
                         jax.tree_util.tree_leaves(jgrads)):
            jg = np.asarray(jg)
            np.testing.assert_allclose(
                g.numpy(), jg, rtol=2e-4,
                atol=1e-6 * max(1.0, np.abs(jg).max()))
        for layer, (st, jst) in enumerate(zip(state, jstate)):
            assert sorted(st) == sorted(jst)
            for k in st:
                jv = np.asarray(jst[k])
                assert tuple(st[k].shape) == jv.shape
                assert not st[k].requires_grad
                np.testing.assert_allclose(
                    st[k].numpy(), jv, rtol=1e-5,
                    atol=1e-5 * max(1.0, np.abs(jv).max()),
                    err_msg=f"step {step} layer {layer} {k}")
    # the phantom row is never written; the batches' rows are
    assert not state[0]["cached_messages_f"][-1].any()
    assert state[0]["cached_messages_f"].abs().sum() > 0


@pytest.mark.parametrize("name", ["toy", "synthetic"])
def test_encode_and_scores_match_jax(name):
    """Test mode: the stored layers sum their basis messages with 'none'
    weights (JAX ``encoders.py:319``, ``:329-331``), so the codes grow
    with the degrees (to ~3,000 on the synthetic graph) and the energies
    to ~1.7e7. The codes are held as every model's (rtol 2e-4, atol
    2e-4); the all-entity energies (before the sigmoid) within rtol 2e-4
    and atol 1e-6 of the largest energy, since a sigmoid input near 0 is a
    cancellation of terms that large."""
    if name == "toy":
        check_encode_and_scores(KIND, name)
        return
    ds, (_, jmodel, jparams, jgraph), (_, model, params, graph) = \
        case(KIND, name)
    want = jmodel.encode(jparams, jgraph, deterministic=True)
    got = model.encode(params, graph, deterministic=True)
    np.testing.assert_allclose(got.entity_codes.numpy(),
                               np.asarray(want.entity_codes), rtol=2e-4,
                               atol=2e-4)
    for fn in ("score_all_subjects", "score_all_objects"):
        want = np.asarray(getattr(jmodel, fn)(jparams, jgraph, ds.test,
                                              apply_sigmoid=False))
        got = getattr(model, fn)(params, graph, ds.test,
                                 apply_sigmoid=False).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=fn)


def test_scorer_ranks_equal_jax():
    check_ranks(KIND, "toy")


def test_param_tree_is_the_basis_tree():
    check_trees(KIND)
    _, _, (_, model, params, _) = case(KIND, "synthetic")
    assert model.variant == "basis_stored" and not model.preferred_staircase2
    assert sorted(params["gcn_layers"][0]) == [
        "C_backward", "C_forward", "W_backward", "W_forward", "W_self", "b"]


@pytest.mark.parametrize("prefetch", [False, True])
def test_trainloop_steps_the_caches(prefetch):
    """TrainLoop on the stored variant: the tiled loss on host-tiled
    batches (also through the prefetch threads), caches stepped by every
    step, losses finite."""
    ds, _, (tcfg, model, _, _) = case(KIND, "toy")
    loop = TrainLoop(model, tcfg, ds, seed=0, log=lambda s: None,
                     prefetch=prefetch, negative_mode="split")
    assert loop.loss_kind == "tiled"
    before = [{k: v.clone() for k, v in st.items()}
              for st in loop.cache_state]
    assert not any(v.any() for st in before for v in st.values())
    result = loop.fit(max_iterations=4)
    assert result.iterations == 4
    assert all(np.isfinite(s["loss"]) for s in result.steps)
    vertex = loop.cache_state[0]["cached_vertex_embeddings"]
    assert vertex.abs().sum() > 0
    assert tuple(loop.cache_state[1]["cached_messages_b"].shape) == (
        len(ds.train) + 1, tcfg.encoder.internal_dimension)


def test_resume_starts_from_zero_caches(tmp_path):
    """Caches are not in a checkpoint: a resumed stored run starts from
    zero caches (``TrainLoop.restore``), and its params are the saved
    ones."""
    ds, _, (tcfg, model, _, _) = case(KIND, "toy")
    path = str(tmp_path / "m")
    loop = TrainLoop(model, tcfg, ds, seed=0, log=lambda s: None,
                     prefetch=False)
    result = loop.fit(max_iterations=3, checkpoint_path=path)
    loop.save(path, result.params, result.opt_state, 3, *([[
        loop.pipeline.state()], 0]))
    assert loop.cache_state[0]["cached_vertex_embeddings"].abs().sum() > 0
    again = TrainLoop(model, tcfg, ds, seed=0, log=lambda s: None,
                      prefetch=False)
    again.cache_state[0]["cached_vertex_embeddings"].fill_(1.0)
    params, _, step = again.restore(path)
    assert step == 3
    assert not any(v.any() for st in again.cache_state for v in st.values())
    for a, b in zip(tree_leaves(params), tree_leaves(result.params)):
        assert torch.equal(a, b)
    resumed = again.resume(path, max_iterations=5)
    assert resumed.iterations == 5
    assert np.isfinite(resumed.last_loss)


def test_checkpoint_and_evaluate_cli_carry_the_tree(tmp_path, capsys):
    check_checkpoint_and_evaluate_cli(tmp_path, capsys, KIND)


def test_train_cli_runs_the_stored_variant_on_cpu(tmp_path):
    check_train_cli(tmp_path, KIND)
