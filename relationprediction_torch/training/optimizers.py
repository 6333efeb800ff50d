"""The update rule: clip by global norm, then Adam, then scale by -lr.

Counterpart of ``relationprediction_tpu/training/optimizers.py:23-49``,
written out as the optax chain ``clip_by_global_norm(c) -> scale_by_adam
-> scale(-lr)`` computes it:

- clip: n = sqrt(sum of squares over every leaf); each g stays as it is if
  n < c, else becomes (g / n) * c. (``torch.nn.utils.clip_grad_norm_``
  divides by n + 1e-6 and is not this.)
- Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count += 1,
  update = mu_hat / (sqrt(nu_hat) + eps) with mu_hat = mu / (1 - b1^count)
  and nu_hat likewise.

The state is optax's: ``{"count", "mu", "nu"}`` with ``mu`` and ``nu``
trees shaped as the params (the GCN layers' unused bias ``b`` included,
with zero gradients), so that optax's state maps onto it. Only Adam, the
algorithm of the shipped settings, is ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import OptimizerConfig
from ..params import map_tree, tree_leaves, tree_unflatten


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm on a list of leaves."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clipped = [(g / norm) * max_norm for g in grads]
    return [torch.where(norm < max_norm, g, c) for g, c in zip(grads,
                                                               clipped)]


class Adam:
    """clip_by_global_norm (when ``max_gradient_norm`` is set) -> Adam ->
    scale(-learning_rate), on parameter trees."""

    def __init__(self, learning_rate: float, max_gradient_norm=None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.max_gradient_norm = max_gradient_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> dict:
        leaves = tree_leaves(params)
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                "mu": map_tree(torch.zeros_like, params),
                "nu": map_tree(torch.zeros_like, params)}

    def update(self, grads, state: dict) -> Tuple[dict, dict]:
        """(updates, new state) for gradient tree ``grads``."""
        g = tree_leaves(grads)
        if self.max_gradient_norm is not None:
            g = clip_by_global_norm(g, self.max_gradient_norm)
        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * x + b1 * m
              for x, m in zip(g, tree_leaves(state["mu"]))]
        nu = [(1 - b2) * (x * x) + b2 * v
              for x, v in zip(g, tree_leaves(state["nu"]))]
        count = state["count"] + 1
        # optax raises the decays to the int32 count in float32
        c1 = 1 - torch.tensor(b1, dtype=torch.float32,
                              device=count.device) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32,
                              device=count.device) ** count
        updates = [(m / c1) / (torch.sqrt(v / c2) + self.eps)
                   * -self.learning_rate for m, v in zip(mu, nu)]
        return (tree_unflatten(grads, updates),
                {"count": count, "mu": tree_unflatten(grads, mu),
                 "nu": tree_unflatten(grads, nu)})


def apply_updates(params, updates) -> None:
    """params += updates, in place (no copy of the parameter tree)."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u)


def build_optimizer(cfg: OptimizerConfig) -> Adam:
    if cfg.algorithm != "Adam":
        raise NotImplementedError(
            f"optimizer {cfg.algorithm!r} is not ported yet (ROADMAP.md "
            f"Queue 1 item 3)")
    kw = dict(cfg.algorithm_kwargs)
    return Adam(cfg.learning_rate, cfg.max_gradient_norm,
                b1=kw.pop("beta1", 0.9), b2=kw.pop("beta2", 0.999),
                eps=kw.pop("epsilon", 1e-8))
