"""Parameters between the JAX package's tree (as numpy) and the port.

The tree is ``{"input_transform": {W, b}, "gcn_layers": [layer, ...],
"relation_embedding": {W_relation}, "decoder": {}}``. A block layer is
``{W_forward, W_backward, W_self, b}`` with block stacks in the JAX layout
[R, B, dr, dr]; a basis layer is ``{C_backward, C_forward, W_backward,
W_forward, W_self, b}`` with bases [d_in, B, d_out] and coefficients
[R, B]; a diag layer (gcn_diag) is ``{D_types_backward, D_types_forward,
W_self, b}`` with D_types [R, d_out] (``jax.tree_util`` order: keys
sorted). A model without an input transform (one-hot input) has no
``input_transform``, and its first basis layer has W_* [V, B, d_out] and
W_self [V, d_out], one row per entity. The other encoders add
``embedding`` or ``mu_embedding`` / ``sigma_embedding`` tables,
``mu_projection`` / ``sigma_projection`` and ``output_transform``
({W, b}), and ``highways``: one gate {W, b} per layer, or None for a
layer without one (a one-hot first layer). As under ``jax.tree_util``,
None is a subtree with no leaves: every function here keeps it as None
and gives it no leaf. The port keeps that structure as dictionaries and
lists of tensors.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def map_tree(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples; None
    stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's order (``jax.tree_util``: dict keys
    sorted, lists in order; None has none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its leaves."""
    return _rebuild(tree, iter(leaves))


def _rebuild(tree, leaves):
    # A module-level function: a recursive closure is a reference cycle
    # whose iterator keeps the whole ``leaves`` list (gradients, Adam's
    # moments, the updates: 4 x the parameters a train step) alive until
    # the cycle collector runs.
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def params_from_jax(tree, device) -> dict:
    """The JAX package's params (numpy leaves) as float32 tensors on
    ``device``."""
    return map_tree(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
        .to(device), tree)


def params_to_numpy(params) -> dict:
    """The port's params as numpy arrays, in the JAX package's tree."""
    return map_tree(lambda t: t.detach().cpu().numpy(), params)
