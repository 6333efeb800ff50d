"""The update rules: clip by global norm, then the algorithm, then -lr.

Counterpart of ``relationprediction_tpu/training/optimizers.py:23-49``,
written out as the optax chain ``clip_by_global_norm(c) -> scale_by_<algo>
-> scale(-lr)`` computes it (the clip only where ``MaxGradientNorm`` is
set):

- clip: n = sqrt(sum of squares over every leaf); each g stays as it is if
  n < c, else becomes (g / n) * c. (``torch.nn.utils.clip_grad_norm_``
  divides by n + 1e-6 and is not this.)
- Adam (``scale_by_adam``): mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 +
  b2 nu, count += 1, update = mu_hat / (sqrt(nu_hat) + eps) with mu_hat =
  mu / (1 - b1^count) and nu_hat likewise.
- AdaGrad (``scale_by_rss``): s = g^2 + s, update = g / sqrt(s + eps)
  where s > 0, else 0; s starts at ``initial_accumulator``.
- RmsProp (``scale_by_rms``): nu = (1 - decay) g^2 + decay nu, update =
  g / sqrt(nu + eps) (eps inside the root); nu starts at 0.
- GradientDescent (``identity``): update = g.

Each state is optax's: ``{"count", "mu", "nu"}``, ``{"sum_of_squares"}``,
``{"nu"}`` or ``{}``, with every tree shaped as the params (the GCN layers'
unused bias ``b`` included, with zero gradients), so that optax's state
maps onto it (``opt_state_from_jax``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import OptimizerConfig
from ..params import map_tree, tree_leaves, tree_unflatten


def clip_by_global_norm(grads: list, max_norm: float,
                        sum_of_squares: Optional[Callable] = None) -> list:
    """optax.clip_by_global_norm on a list of leaves. ``sum_of_squares``:
    the global sum of squares from the leaves, where some leaf is a
    rank's block of a sharded array (the vertex-sharded step); by default
    the sum over the leaves here."""
    if sum_of_squares is None:
        total = sum((g * g).sum() for g in grads)
    else:
        total = sum_of_squares(grads)
    norm = torch.sqrt(total)
    clipped = [(g / norm) * max_norm for g in grads]
    return [torch.where(norm < max_norm, g, c) for g, c in zip(grads,
                                                               clipped)]


def _adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    # The decays as float32 0-d tensors, made once on each device by a fill
    # (no host-to-device copy, which a CUDA graph's capture refuses).
    decays = {}

    def init(params):
        leaves = tree_leaves(params)
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                "mu": map_tree(torch.zeros_like, params),
                "nu": map_tree(torch.zeros_like, params)}

    def update(g: list, state: dict, tree) -> Tuple[list, dict]:
        mu = [(1 - b1) * x + b1 * m
              for x, m in zip(g, tree_leaves(state["mu"]))]
        nu = [(1 - b2) * (x * x) + b2 * v
              for x, v in zip(g, tree_leaves(state["nu"]))]
        count = state["count"] + 1
        if count.device not in decays:
            decays[count.device] = tuple(
                torch.full((), b, dtype=torch.float32, device=count.device)
                for b in (b1, b2))
        d1, d2 = decays[count.device]
        # optax raises the decays to the int32 count in float32
        c1 = 1 - d1 ** count
        c2 = 1 - d2 ** count
        updates = [(m / c1) / (torch.sqrt(v / c2) + eps)
                   for m, v in zip(mu, nu)]
        return updates, {"count": count, "mu": tree_unflatten(tree, mu),
                         "nu": tree_unflatten(tree, nu)}
    return init, update


def _rss(initial_accumulator: float = 0.1, eps: float = 1e-7):
    def init(params):
        return {"sum_of_squares": map_tree(
            lambda p: torch.full_like(p, initial_accumulator), params)}

    def update(g: list, state: dict, tree) -> Tuple[list, dict]:
        sums = [x * x + s for x, s in
                zip(g, tree_leaves(state["sum_of_squares"]))]
        # optax guards the root, not the division: 0 where the sum is 0
        updates = [torch.where(s > 0, torch.rsqrt(s + eps),
                               torch.zeros_like(s)) * x
                   for x, s in zip(g, sums)]
        return updates, {"sum_of_squares": tree_unflatten(tree, sums)}
    return init, update


def _rms(decay: float = 0.9, eps: float = 1e-10):
    def init(params):
        return {"nu": map_tree(torch.zeros_like, params)}

    def update(g: list, state: dict, tree) -> Tuple[list, dict]:
        nu = [(1 - decay) * (x * x) + decay * v
              for x, v in zip(g, tree_leaves(state["nu"]))]
        updates = [torch.rsqrt(v + eps) * x for v, x in zip(nu, g)]
        return updates, {"nu": tree_unflatten(tree, nu)}
    return init, update


def _identity():
    def update(g: list, state: dict, tree) -> Tuple[list, dict]:
        return g, {}
    return (lambda params: {}), update


class Optimizer:
    """clip_by_global_norm (when ``max_gradient_norm`` is set) -> one
    algorithm's (init, update) pair -> scale(-learning_rate), on parameter
    trees."""

    def __init__(self, init: Callable, update: Callable,
                 learning_rate: float, max_gradient_norm=None):
        self.learning_rate = learning_rate
        self.max_gradient_norm = max_gradient_norm
        self._init, self._update = init, update

    def init(self, params) -> dict:
        return self._init(params)

    def update(self, grads, state: dict,
               sum_of_squares: Optional[Callable] = None
               ) -> Tuple[dict, dict]:
        """(updates, new state) for gradient tree ``grads``;
        ``sum_of_squares``: see ``clip_by_global_norm``."""
        g = tree_leaves(grads)
        if self.max_gradient_norm is not None:
            g = clip_by_global_norm(g, self.max_gradient_norm,
                                    sum_of_squares)
        updates, state = self._update(g, state, grads)
        return (tree_unflatten(grads, [u * -self.learning_rate
                                       for u in updates]), state)


def apply_updates(params, updates) -> None:
    """params += updates, in place (no copy of the parameter tree)."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u)


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    """The chain of ``cfg.algorithm`` with the JAX package's defaults
    (``optimizers.py:28-42``); an unknown name raises ValueError."""
    kw = dict(cfg.algorithm_kwargs)
    name = cfg.algorithm
    if name == "Adam":
        pair = _adam(b1=kw.pop("beta1", 0.9), b2=kw.pop("beta2", 0.999),
                     eps=kw.pop("epsilon", 1e-8))
    elif name == "GradientDescent":
        pair = _identity()
    elif name == "AdaGrad":
        pair = _rss(initial_accumulator=kw.pop("initial_accumulator", 0.1),
                    eps=kw.pop("epsilon", 1e-7))
    elif name == "RmsProp":
        pair = _rms(decay=kw.pop("decay", 0.9), eps=kw.pop("epsilon", 1e-10))
    else:
        raise ValueError(f"unknown optimizer algorithm {name!r}")
    return Optimizer(*pair, cfg.learning_rate, cfg.max_gradient_norm)


# The optax state class that carries each algorithm's fields, and the
# port's key for each field, in optax's field order.
_OPTAX_STATES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "Adam": ("ScaleByAdamState", ("count", "mu", "nu")),
    "AdaGrad": ("ScaleByRssState", ("sum_of_squares",)),
    "RmsProp": ("ScaleByRmsState", ("nu",)),
}


def _class_name(obj) -> str:
    return getattr(type(obj), "_qualname", "").rsplit(".", 1)[-1]


def opt_state_from_jax(obj, algorithm: str, device="cpu") -> dict:
    """The port's state for ``algorithm`` from the JAX package's optax
    chain state, as ``checkpoint.restore`` returns it: a tuple of
    placeholders whose ``args`` are the NamedTuple's fields, e.g.
    ``(EmptyState, ScaleByAdamState(count, mu, nu), EmptyState)`` with
    clipping, or without the leading clip state. Every other member must
    be an ``EmptyState`` (the clip and the scale keep none). Raises
    ValueError for a state of another algorithm or chain."""
    if not isinstance(obj, tuple):
        raise ValueError(f"optax chain state expected, got {type(obj)!r}")
    want = _OPTAX_STATES.get(algorithm)
    if want is None and algorithm != "GradientDescent":
        raise ValueError(f"unknown optimizer algorithm {algorithm!r}")
    found = None
    for member in obj:
        name = _class_name(member)
        if want is not None and name == want[0]:
            if found is not None:
                raise ValueError(f"two {name} in the optax chain state")
            found = member
        elif name != "EmptyState":
            raise ValueError(f"optax state {name or type(member)!r} does "
                             f"not belong to {algorithm}'s chain")
    if want is None:
        return {}
    if found is None or len(found.args) != len(want[1]):
        raise ValueError(f"no {want[0]} with fields {want[1]} in the optax "
                         f"chain state for {algorithm}")
    return map_tree(lambda a: torch.from_numpy(np.array(a)).to(device),
                    dict(zip(want[1], found.args)))
