"""The port's clip -> algorithm -> -lr against the JAX package's optax
chain on random trees, below and above the clipping threshold and without
clipping, for every algorithm; and optax's saved state read into the
port's."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu.config import OptimizerConfig as JaxOptimizerConfig
from relationprediction_tpu.training import checkpoint as jax_ckpt
from relationprediction_tpu.training.optimizers import (
    build_optimizer as jax_optimizer)
from relationprediction_torch.config import OptimizerConfig
from relationprediction_torch.params import map_tree, tree_leaves
from relationprediction_torch.training import checkpoint as torch_ckpt
from relationprediction_torch.training.optimizers import (
    apply_updates, build_optimizer, clip_by_global_norm, opt_state_from_jax)


def random_tree(rng, scale):
    """A params-shaped tree with an all-zero leaf (the unused bias)."""
    def leaf(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"input_transform": {"W": leaf(7, 5), "b": leaf(5)},
            "gcn_layers": [{"W_forward": leaf(3, 2, 2, 2),
                            "W_self": leaf(5, 4),
                            "b": np.zeros(4, np.float32)}],
            "relation_embedding": {"W_relation": leaf(3, 4)},
            "decoder": {}}


def to_torch(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


ALGORITHMS = ["Adam", "GradientDescent", "AdaGrad", "RmsProp"]
# (gradient scale, MaxGradientNorm): below the clipping threshold, above
# it (every step clipped), and no clipping at all.
CLIPS = [(0.01, 1.0), (3.0, 1.0), (3.0, None)]
# The port's state keys of each algorithm, optax's field names.
STATE_KEYS = {"Adam": ("count", "mu", "nu"), "GradientDescent": (),
              "AdaGrad": ("sum_of_squares",), "RmsProp": ("nu",)}


def optax_fields(jstate):
    """{field: value} of the one optax state in the chain that has any."""
    fields = {}
    for member in jstate:
        fields.update(getattr(member, "_asdict", dict)())
    return fields


def three_steps(algorithm, grad_scale, max_norm):
    """The port's and optax's params and states after 3 steps from the
    same random params and gradients."""
    rng = np.random.default_rng(0)
    params_np = random_tree(rng, 1.0)
    jcfg = JaxOptimizerConfig(algorithm=algorithm, learning_rate=0.01,
                              max_gradient_norm=max_norm)
    cfg = OptimizerConfig(**dataclasses.asdict(jcfg))
    jopt, opt = jax_optimizer(jcfg), build_optimizer(cfg)
    jparams = jax.tree_util.tree_map(np.array, params_np)
    params = to_torch(params_np)
    jstate, state = jopt.init(jparams), opt.init(params)
    norms = []
    for _ in range(3):
        grads_np = random_tree(rng, grad_scale)
        norms.append(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                 for g in jax.tree_util.tree_leaves(
                                     grads_np))))
        updates, jstate = jopt.update(grads_np, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        updates, state = opt.update(to_torch(grads_np), state)
        apply_updates(params, updates)
        yield params, jparams, state, jstate, norms


@pytest.mark.parametrize("grad_scale,max_norm", CLIPS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_three_steps_equal_optax(algorithm, grad_scale, max_norm):
    """grad_scale 0.01 keeps the global norm below 1 (no clipping), 3.0
    puts it above (every step clipped, or not where MaxGradientNorm is
    unset). rtol 1e-5: the global norm sums the squares in another order
    than XLA, a few float32 ulps apart; atol 1e-8 on the states, where
    mu's sum cancels to ~1e-4."""
    for params, jparams, state, jstate, norms in three_steps(
            algorithm, grad_scale, max_norm):
        for p, jp in zip(tree_leaves(params),
                         jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp),
                                       rtol=1e-5, atol=1e-7)
        want = optax_fields(jstate)
        assert sorted(state) == sorted(want) == sorted(STATE_KEYS[algorithm])
        for name in STATE_KEYS[algorithm]:
            for m, jm in zip(tree_leaves(state[name]),
                             jax.tree_util.tree_leaves(want[name])):
                np.testing.assert_allclose(m.numpy(), np.asarray(jm),
                                           rtol=1e-5, atol=1e-8)
    assert (max(norms) < 1.0) == (grad_scale < 1.0)
    if algorithm == "Adam":
        assert int(state["count"]) == int(optax_fields(jstate)["count"]) == 3
    # the unused bias: zero gradients leave it where it was (AdaGrad's
    # guard and RmsProp's eps keep 0 / sqrt(.) finite)
    assert not params["gcn_layers"][0]["b"].any()


@pytest.mark.parametrize("max_norm", [1.0, None])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_opt_state_from_jax_reads_saved_optax_state(tmp_path, algorithm,
                                                    max_norm):
    """The optax chain state after 3 steps, written by the JAX package's
    checkpoint.save and read by the port's restricted unpickler, becomes
    the port's state for the same algorithm bit for bit; another
    algorithm's reading of it raises."""
    *_, (_, _, _, jstate, _) = three_steps(algorithm, 3.0, max_norm)
    jax_ckpt.save(str(tmp_path / "m"), params={}, opt_state=jstate, step=3,
                  rng_key=jax.random.PRNGKey(1))
    obj = torch_ckpt.restore_latest(str(tmp_path / "m"))["opt_state"]
    state = opt_state_from_jax(obj, algorithm)
    want = optax_fields(jstate)
    assert sorted(state) == sorted(want)
    for name in state:
        for m, jm in zip(tree_leaves(state[name]),
                         jax.tree_util.tree_leaves(want[name])):
            assert m.dtype == torch.from_numpy(np.array(jm)).dtype
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    other = "RmsProp" if algorithm == "Adam" else "Adam"
    with pytest.raises(ValueError):
        opt_state_from_jax(obj, other)


def test_clip_is_optax_not_clip_grad_norm():
    """g * c / n above the threshold (clip_grad_norm_ would divide by
    n + 1e-6), untouched below it."""
    g = [torch.tensor([3.0, 4.0])]
    (clipped,) = clip_by_global_norm(g, 1.0)
    assert clipped.tolist() == [0.6000000238418579, 0.800000011920929]
    (same,) = clip_by_global_norm(g, 5.5)
    assert torch.equal(same, g[0])


def test_only_adam_is_ported():
    """Every algorithm of the JAX package is ported; an unknown name
    raises ValueError, as there (``optimizers.py:41-42``)."""
    with pytest.raises(ValueError, match="unknown optimizer algorithm"):
        build_optimizer(OptimizerConfig(algorithm="Adagrad"))
