"""The port's clip -> Adam -> -lr against the JAX package's optax chain on
random trees, below and above the clipping threshold."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu.config import OptimizerConfig as JaxOptimizerConfig
from relationprediction_tpu.training.optimizers import (
    build_optimizer as jax_optimizer)
from relationprediction_torch.config import OptimizerConfig
from relationprediction_torch.params import map_tree, tree_leaves
from relationprediction_torch.training.optimizers import (
    apply_updates, build_optimizer, clip_by_global_norm)


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


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])
def test_three_steps_equal_optax(grad_scale):
    """grad_scale 0.01 keeps the global norm below 1 (no clipping), 3.0
    puts it above (every step clipped). rtol 1e-5: the global norm sums
    the squares in another order than XLA, a few float32 ulps apart; atol
    1e-8 on the moments, where mu's sum cancels to ~1e-4."""
    rng = np.random.default_rng(0)
    params_np = random_tree(rng, 1.0)
    jcfg = JaxOptimizerConfig(learning_rate=0.01, max_gradient_norm=1.0)
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
        for p, jp in zip(tree_leaves(params),
                         jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp),
                                       rtol=1e-5, atol=1e-7)
        for name in ("mu", "nu"):
            for m, jm in zip(tree_leaves(state[name]),
                             jax.tree_util.tree_leaves(
                                 getattr(jstate[1], name))):
                np.testing.assert_allclose(m.numpy(), np.asarray(jm),
                                           rtol=1e-5, atol=1e-8)
    assert (max(norms) < 1.0) == (grad_scale < 1.0)
    assert int(state["count"]) == int(jstate[1].count) == 3
    # the unused bias: zero gradients leave it and its moments at zero
    assert not params["gcn_layers"][0]["b"].any()
    assert not state["nu"]["gcn_layers"][0]["b"].any()


def test_clip_is_optax_not_clip_grad_norm():
    """g * c / n above the threshold (clip_grad_norm_ would divide by
    n + 1e-6), untouched below it."""
    g = [torch.tensor([3.0, 4.0])]
    (clipped,) = clip_by_global_norm(g, 1.0)
    assert clipped.tolist() == [0.6000000238418579, 0.800000011920929]
    (same,) = clip_by_global_norm(g, 5.5)
    assert torch.equal(same, g[0])


def test_only_adam_is_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_optimizer(OptimizerConfig(algorithm="AdaGrad"))
