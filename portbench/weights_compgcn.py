"""Seeded weights of the CompGCN configuration, made on the device.

One ``torch.randn`` on a generator of the device seeded with the run's
seed, cut into the drawn leaves of the port's parameter tree and scaled
to the standard deviations of the official code's initialisers:
``get_param``'s xavier normal (sqrt(2 / (fan_in + fan_out))) for the
tables, the layer's weights and the self-loop relation, and the standard
deviation of ``torch.nn``'s default U(-1/sqrt(fan_in), 1/sqrt(fan_in))
(1/sqrt(3 fan_in)) for the filters and the scorer's map and its bias.
BatchNorm's scales start at 1, every shift and bias at 0. The same tree
is handed to the port and to the reference.
"""
from __future__ import annotations

import math

import torch

from .reference.compgcn import Spec


def xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0 / (fan_in + fan_out))


def uniform_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(3.0 * fan_in)


def leaf_shapes(spec: Spec, n_vertices: int, n_relations: int) -> list:
    """(path, shape, std) of every leaf; std None for a leaf of zeros, the
    string "ones" for one of ones."""
    d, di, f, k = spec.d, spec.d_in, spec.n_filters, spec.kernel
    r2 = 2 * n_relations
    flat = (2 * spec.k_w - k + 1) * (spec.k_h - k + 1) * f
    layer = ("compgcn_layers", 0)
    out = [(("entity_embedding", "W"), (n_vertices, di),
            xavier(di, n_vertices)),
           (("relation_embedding", "W_relation"), (r2, di), xavier(di, r2))]
    out += [(layer + (f"W_{w}",), (di, d), xavier(di, d))
            for w in ("in", "out", "loop", "rel")]
    out += [(layer + ("loop_rel",), (1, di), xavier(di, 1)),
            (layer + ("bn_weight",), (d,), "ones"),
            (layer + ("bn_bias",), (d,), None)]
    dec = ("decoder",)
    out += [(dec + ("conv_W",), (f, 1, k, k), uniform_std(k * k)),
            (dec + ("fc_W",), (flat, d), uniform_std(flat)),
            (dec + ("fc_b",), (d,), uniform_std(flat)),
            (dec + ("entity_bias",), (n_vertices,), None)]
    for name, n in (("bn0", 1), ("bn1", f), ("bn2", d)):
        out += [(dec + (f"{name}_weight",), (n,), "ones"),
                (dec + (f"{name}_bias",), (n,), None)]
    return out


def make_params(spec: Spec, n_vertices: int, n_relations: int, seed: int,
                device) -> dict:
    """The parameter tree, its drawn leaves from one call on ``device``."""
    shapes = leaf_shapes(spec, n_vertices, n_relations)
    drawn = [s for s in shapes if isinstance(s[2], float)]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    params: dict = {"entity_embedding": {}, "relation_embedding": {},
                    "compgcn_layers": [{}], "decoder": {}}
    offset = 0
    for path, shape, std in shapes:
        if std is None:
            leaf = torch.zeros(shape, device=device)
        elif std == "ones":
            leaf = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            leaf = flat[offset:offset + n].view(shape) * std
            offset += n
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return params
