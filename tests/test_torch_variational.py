"""The variational encoders through the port on the CPU against the JAX
package: variational_embedding (distmult.exp with
Name=variational_embedding: mu and sigma tables, no graph) and
variational_gcn_basis (gcn_basis.exp with Name=variational_gcn_basis: the
basis R-GCN on TPU kernel 2, then mu and log-sigma projections onto a
16-wide code). JAX's own noise goes to the port (fold_in 17 and 31 of the
step's key, ``PRNGKey(0)`` in test mode): codes, scores and ranks, one
step's loss and every gradient leaf, params after Adam steps; the KL
penalty against JAX's ``variational_kl_penalty``; and the KL term inside
each of the four training losses (tiled, factored binomial, split,
shared)."""
import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu.models import encoders as jax_enc
from relationprediction_tpu.training import device_sampling as jax_draw
from relationprediction_torch.models import encoders as torch_enc
from relationprediction_torch.params import tree_leaves
from relationprediction_torch.training.engine import (Draws, TrainBatch,
                                                      step_loss_and_grads)

from test_torch_onehot_model import (case, check_adam_steps,
                                     check_encode_and_scores,
                                     check_evaluate_cli_runs,
                                     check_loss_and_grads, check_ranks,
                                     check_train_cli, check_trees, jax_noise)
from test_torch_train_step import jax_draws

KINDS = ["vemb", "vgcn"]


@pytest.mark.parametrize("kind", KINDS)
def test_encode_and_scores_match_jax(kind):
    check_encode_and_scores(kind, "synthetic")


@pytest.mark.parametrize("kind", KINDS)
def test_scorer_ranks_equal_jax(kind):
    check_ranks(kind, "toy")


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_every_gradient_leaf_match_jax(kind):
    # The KL's exp(2 log sigma) makes variational_gcn_basis's leaves reach
    # 4-320 where the other models' stay near 1: atol 1e-4 is 3e-7 to
    # 2.5e-5 of each leaf's largest entry (its worst entry here is 4.5e-4
    # off in relative terms at 2.5e-6 absolute).
    grads = check_loss_and_grads(kind, "synthetic",
                                 grad_atol=1e-4 if kind == "vgcn" else 1e-6)
    stats = ("mu_embedding", "sigma_embedding") if kind == "vemb" \
        else ("mu_projection", "sigma_projection")
    for key in stats:
        assert grads[key]["W"].abs().max() > 0, key


@pytest.mark.parametrize("kind", KINDS)
def test_params_after_optimizer_steps_match_optax(kind):
    check_adam_steps(kind, "synthetic")


@pytest.mark.parametrize("kind", KINDS)
def test_param_tree_matches_jax(kind):
    check_trees(kind)
    ds, _, (tcfg, model, params, _) = case(kind, "synthetic")
    assert model.variational
    e = tcfg.encoder
    if kind == "vemb":
        assert sorted(params) == ["decoder", "mu_embedding",
                                  "relation_embedding", "sigma_embedding"]
        assert not model.needs_graph()
    else:
        for key in ("mu_projection", "sigma_projection"):
            assert tuple(params[key]["W"].shape) == (e.internal_dimension,
                                                     e.code_dimension)
        assert model.preferred_staircase2


def test_kl_penalty_matches_jax():
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(50, 16)).astype(np.float32)
    log_sigma = rng.normal(scale=0.5, size=(50, 16)).astype(np.float32)
    want = float(jax_enc.variational_kl_penalty(mu, log_sigma))
    got = torch_enc.variational_kl_penalty(torch.from_numpy(mu),
                                           torch.from_numpy(log_sigma))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    eps = rng.normal(size=mu.shape).astype(np.float32)
    np.testing.assert_allclose(
        torch_enc.apply_variational(*map(torch.from_numpy,
                                         (eps, mu, log_sigma))).numpy(),
        mu + np.exp(log_sigma) * eps, rtol=1e-6, atol=1e-6)


def test_test_mode_noise_is_the_same_at_every_encode():
    """Test mode draws its noise from one fixed seed at every encode, as
    JAX's ``PRNGKey(0)`` (the reference draws noise in test mode too)."""
    _, _, (_, model, params, graph) = case("vgcn", "toy")
    a = model.encode(params, graph, deterministic=True)
    b = model.encode(params, graph, deterministic=True)
    assert torch.equal(a.entity_codes, b.entity_codes)
    assert not torch.equal(a.entity_codes, a.mu)


def losses_case(kind):
    """A full batch (no padding rows: JAX's split and shared masks are
    right only there) of 800 positives, JAX's draws of one step for every
    loss, and the JAX and port models' params and graphs."""
    ds, (jcfg, jmodel, jparams, jgraph), (tcfg, model, params, graph) = \
        case(kind, "synthetic")
    pos = np.asarray(ds.train[:800], dtype=np.int32)
    mask = np.ones(len(pos), np.float32)
    key, values, co, masks = jax_draws(jcfg, jmodel, pos, 0)
    rate, v = jcfg.training.negative_sample_rate, jcfg.entity_count
    tiled = jax_draw.device_negative_sample(pos, mask, rate, v,
                                            jax.random.fold_in(key, 777))
    neg_s, neg_o = jax_draw.device_negative_entities_split(
        pos, rate, v, jax.random.fold_in(key, 777))
    pool = np.array(jax.random.randint(jax.random.fold_in(key, 778), (64,),
                                       0, v, dtype=np.int32))
    return dict(ds=ds, jmodel=jmodel, jparams=jparams, jgraph=jgraph,
                model=model, params=params, graph=graph, pos=pos, mask=mask,
                key=key, values=values, co=co, masks=masks, tiled=tiled,
                neg_s=neg_s, neg_o=neg_o, pool=pool)


@pytest.mark.parametrize("loss", ["tiled", "factored", "split", "shared"])
@pytest.mark.parametrize("kind", KINDS)
def test_kl_term_in_every_loss_matches_jax(kind, loss):
    """Each loss with its KL term against JAX's, and its gradient; the KL
    part alone against JAX's penalty of the step's mu and log sigma."""
    c = losses_case(kind)
    jm, jg, key = c["jmodel"], c["jgraph"], c["key"]
    pos, mask = c["pos"], c["mask"]
    jfn = {"tiled": lambda p: jm.loss(p, jg, *c["tiled"], rng=key),
           "factored": lambda p: jm.loss_binomial_factored(
               p, jg, pos, mask, c["values"], c["co"], rng=key),
           "split": lambda p: jm.loss_structured(
               p, jg, pos, mask, c["neg_s"], c["neg_o"], rng=key),
           "shared": lambda p: jm.loss_shared_negatives(
               p, jg, pos, mask, c["pool"], rng=key)}[loss]
    want, jgrads = jax.value_and_grad(jfn)(c["jparams"])

    def t(a):
        return torch.from_numpy(np.array(a))
    negatives = {"tiled": tuple(map(t, c["tiled"])),
                 "factored": (t(c["values"]), t(c["co"])),
                 "split": (t(c["neg_s"]), t(c["neg_o"])),
                 "shared": (t(c["pool"]),)}[loss]
    noise = jax_noise(kind, "synthetic", key)
    draws = Draws(negatives, [t(m) for m in c["masks"]], noise)
    batch = TrainBatch(c["graph"], t(pos), t(mask))
    got, grads = step_loss_and_grads(c["model"], loss, c["params"], batch,
                                     draws)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, jgr in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        # atol as in test_loss_and_every_gradient_leaf_match_jax
        np.testing.assert_allclose(g.numpy(), np.asarray(jgr), rtol=2e-4,
                                   atol=1e-4 if kind == "vgcn" else 1e-6)
    # the KL part: JAX's penalty of this step's statistics
    encoded = c["model"].encode(c["params"], c["graph"], deterministic=False,
                                keep_masks=draws.keep_masks, noise=noise)
    jenc = jm.encode(c["jparams"], jg, deterministic=False, rng=key)
    kl = c["model"].plus_kl(torch.zeros(()), encoded)
    np.testing.assert_allclose(
        kl.item(), float(jax_enc.variational_kl_penalty(jenc.mu,
                                                        jenc.log_sigma)),
        rtol=1e-5)
    assert kl.item() != 0.0


def test_train_cli_runs_variational_embedding_on_cpu(tmp_path):
    check_train_cli(tmp_path, "vemb")


def test_evaluate_cli_runs_variational_gcn_basis(tmp_path, capsys):
    check_evaluate_cli_runs(tmp_path, capsys, "vgcn")
