"""Seeded weights of an R-GCN configuration, made on the device.

One ``torch.randn`` on a generator of the device seeded with the run's
seed, cut into the leaves of the port's parameter tree and scaled to the
standard deviations of RelationPrediction's initialisers (its
``glorot_variance``, 3 / sqrt(fan_in + fan_out), used as a standard
deviation); biases start at zero. The same tree is handed to the port and
to the reference.
"""
from __future__ import annotations

import math

import torch

from .reference.rgcn import Spec


def glorot_std(fan_in: int, fan_out: int) -> float:
    return 3.0 / math.sqrt(fan_in + fan_out)


def leaf_shapes(spec: Spec, n_vertices: int, n_relations: int) -> list:
    """(path, shape, std) of every leaf; std None for a zero leaf."""
    d, b = spec.d, spec.n_blocks
    out = [(("input_transform", "W"), (n_vertices, d),
            glorot_std(n_vertices, d)),
           (("input_transform", "b"), (d,), None)]
    for i in range(spec.n_layers):
        key = ("gcn_layers", i)
        if spec.variant == "block":
            g = glorot_std(n_relations, spec.dr)
            for direction in ("forward", "backward"):
                out.append((key + (f"W_{direction}",),
                            (n_relations, b, spec.dr, spec.dr), g))
            out.append((key + ("W_self",), (d, d), g))
        else:
            g = glorot_std(d, d)
            for direction in ("forward", "backward"):
                out.append((key + (f"W_{direction}",), (d, b, d), g))
            for direction in ("forward", "backward"):
                out.append((key + (f"C_{direction}",), (n_relations, b), 1.0))
            out.append((key + ("W_self",), (d, d), g))
        out.append((key + ("b",), (d,), None))
    out.append((("relation_embedding", "W_relation"), (n_relations, d), 1.0))
    return out


def make_params(spec: Spec, n_vertices: int, n_relations: int, seed: int,
                device) -> dict:
    """The parameter tree, drawn in one call on ``device``."""
    shapes = leaf_shapes(spec, n_vertices, n_relations)
    drawn = [s for s in shapes if s[2] is not None]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    params: dict = {"input_transform": {}, "gcn_layers": [
        {} for _ in range(spec.n_layers)], "relation_embedding": {},
        "decoder": {}}
    offset = 0
    for path, shape, std in shapes:
        if std is None:
            leaf = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            leaf = flat[offset:offset + n].view(shape) * std
            offset += n
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return params
