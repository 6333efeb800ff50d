"""Model FLOPs of the R-GCN configurations, from the model's equations.

Counted in the direct per-edge form of Schlichtkrull et al. (2017), eq. 2,
not in the port's restructuring: each message edge's product with its
relation's weights (block-diagonal: B blocks of dr x dr; basis: x W_b for
each of the B bases, then their combination), its weighted sum into the
target, the self-loop product over every vertex, and DistMult's
three-way product for every scored triple. Elementwise passes (bias,
ReLU, dropout, the loss's logistic terms) are not counted. A training
step counts its backward pass as twice the forward.
"""
from __future__ import annotations


def message_flops(shape: dict) -> int:
    """FLOPs of one message edge in one direction of one layer: its
    product with the relation's weights and its weighted sum."""
    d = shape["d"]
    if shape["variant"] == "block":
        product = 2 * d * shape["dr"]
    elif shape["variant"] == "basis":
        b = shape["n_bases"]
        product = 2 * d * b * d + 2 * b * d
    else:
        raise ValueError(f"no work function for {shape['variant']!r}")
    return product + 2 * d


def encode_flops(shape: dict, n_vertices: int, n_message_edges: int) -> int:
    """One encode: every layer's two directions over the message edges and
    its self-loop over all vertices (the one-hot input transform is a
    table read)."""
    d = shape["d"]
    per_layer = 2 * n_message_edges * message_flops(shape) \
        + 2 * n_vertices * d * d
    return shape["n_layers"] * per_layer


def train_step_flops(shape: dict, n_vertices: int, n_message_edges: int,
                     n_positives: int, rate: int) -> int:
    """One training step of the binomial loss: the train-mode encode, the
    energies of the positives and of their ``rate`` corruptions each, and
    the backward pass at twice the forward."""
    scored = n_positives * (rate + 1)
    forward = encode_flops(shape, n_vertices, n_message_edges) \
        + 3 * shape["d"] * scored
    return 3 * forward
