"""Model FLOPs of the CompGCN configuration, from the model's equations.

Counted in the official code's per-edge form (Vashishth et al. 2020), not
in the port's: every composed edge (each message edge of both halves and
each entity's self-loop) takes its circular correlation at the
definition's 2 d_in^2 (a PR that computes ccorr another way does not move
the count) and its product with the half's weights, 2 d_in d; each message
edge its weighted sum into the target, 2 d; the relations' update 2 (2R)
d_in d. A query takes ConvE's convolution (2 k^2 per filter output), the
map to d (2 flat d) and the product with every entity (2 d V). Elementwise
passes (BatchNorm, dropout, tanh, the loss) are not counted. A training
step counts its backward pass as twice the forward.
"""
from __future__ import annotations


def forward_flops(shape: dict, composed_edges: int, queries: int) -> int:
    """One train-mode forward pass: ``composed_edges`` compositions (the
    step's counter) and ``queries`` scored queries."""
    d_in, d, v = shape["d_in"], shape["d"], shape["n_vertices"]
    messages = composed_edges - v
    encode = composed_edges * (2 * d_in * d_in + 2 * d_in * d) \
        + messages * 2 * d + 2 * (2 * shape["n_relations"]) * d_in * d
    k, f = shape["kernel"], shape["n_filters"]
    outputs = shape["conv_height"] * shape["conv_width"]
    per_query = 2 * k * k * f * outputs + 2 * f * outputs * d + 2 * d * v
    return encode + queries * per_query


def train_step_flops(shape: dict, composed_edges: int, queries: int) -> int:
    """One training step: the forward pass and the backward at twice it."""
    return 3 * forward_flops(shape, composed_edges, queries)
