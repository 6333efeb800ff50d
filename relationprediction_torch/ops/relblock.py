"""Per-edge relational messages for the layers that aggregate through
``staircase.staircase_aggregate`` (counterpart of
``relationprediction_tpu/ops/relblock.py``).

Messages are built for the edges of one direction's CSR, in its entry
order (``edge_vertices`` = the layout's ``src``, ``edge_relations`` its
``rel``), so the aggregation needs no permutation. Every gather of a table
by those ids is ``gather.take_rows``, whose gradient sums by id in a fixed
order.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import exact_float32
from .gather import take_rows

_EDGE_CHUNK = 16384


def basis_vertex_projection(features: Optional[torch.Tensor],
                            w_flat: torch.Tensor,
                            n_bases: int) -> torch.Tensor:
    """[V, d_in] x [d_in, B * d_out] -> [V, B, d_out] (``relblock.py:25-38``).

    ``features`` None means one-hot input (a first layer without an input
    transform): the projection is the weight itself, W [V, B, d_out]. With
    dense input it is one ``torch.matmul`` in full float32, as the JAX
    package leaves it to XLA.
    """
    if features is None:
        proj = w_flat
    else:
        exact_float32()
        proj = torch.matmul(features, w_flat)
    return proj.reshape(proj.shape[0], n_bases, -1)


def basis_messages(proj: torch.Tensor, coefficients: torch.Tensor,
                   edge_vertices: torch.Tensor, edge_relations: torch.Tensor,
                   edge_chunk: int = _EDGE_CHUNK) -> torch.Tensor:
    """[E, d_out] messages sum_b C[r_e, b] * proj[v_e, b, :]
    (``relblock.py:41-52``), over chunks of edges so the gathered
    [chunk, B, d_out] rows stay bounded (164 MB at 16,384 edges, B=5,
    d=500; all 272,115 edges of FB15k-237 at once would be 2.7 GB).

    The JAX package's dense v1 layer instead multiplies each gathered
    feature row by W_flat (``basis_messages_chunked``, ``relblock.py:
    136-161``: 680 GFLOP a direction on the full FB15k-237 graph);
    ``basis_vertex_projection`` followed by this is the same function
    (36.4 GFLOP a direction), rounded otherwise: the product is taken per
    vertex before the gather, not per edge after it.
    """
    n_edges = edge_vertices.shape[0]
    out = proj.new_empty(n_edges, proj.shape[2])
    for start in range(0, n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        out[sl] = torch.einsum("eb,ebd->ed",
                               take_rows(coefficients, edge_relations[sl]),
                               take_rows(proj, edge_vertices[sl]))
    return out


def basis_messages_scaled(proj: torch.Tensor, coefficients: torch.Tensor,
                          edge_vertices: torch.Tensor,
                          edge_relations: torch.Tensor,
                          edge_chunk: int = _EDGE_CHUNK) -> torch.Tensor:
    """[E, d_out] messages sum_b proj[v_e, b, :] * sigmoid(C[r_e, b, :])
    with full [R, B, d_out] coefficients (``relblock.py:55-63``,
    BasisGcnTimesDiag). The sigmoid is taken once on the [R, B, d_out]
    table, not on its [E, B, d_out] gather (the same values elementwise),
    and the edges go in chunks as in ``basis_messages``."""
    scale = torch.sigmoid(coefficients)
    n_edges = edge_vertices.shape[0]
    out = proj.new_empty(n_edges, proj.shape[2])
    for start in range(0, n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        out[sl] = (take_rows(proj, edge_vertices[sl])
                   * take_rows(scale, edge_relations[sl])).sum(1)
    return out


def block_diag_messages(features: torch.Tensor, blocks: torch.Tensor,
                        edge_vertices: torch.Tensor,
                        edge_relations: torch.Tensor,
                        edge_chunk: int = _EDGE_CHUNK) -> torch.Tensor:
    """[E, d] block-diagonal messages y[b*dr + i] = sum_j W[r_e, b, i, j] *
    x[v_e, b*dr + j] (``relblock.py:66-84``), over chunks of edges so the
    gathered [chunk, B, dr, dr] blocks stay bounded. The block layer's
    unfused route: only the vertex-sharded path's overlapped schedule
    takes it (``parallel/vertex_sharded.py``); every other block layer
    runs the fused kernel."""
    n_blocks, dr = blocks.shape[1], blocks.shape[2]
    n_edges = edge_vertices.shape[0]
    out = features.new_empty(n_edges, n_blocks * dr)
    for start in range(0, n_edges, edge_chunk):
        sl = slice(start, start + edge_chunk)
        x = take_rows(features, edge_vertices[sl]).view(-1, n_blocks, dr)
        out[sl] = torch.einsum("ebij,ebj->ebi",
                               take_rows(blocks, edge_relations[sl]),
                               x).reshape(-1, n_blocks * dr)
    return out


def relation_bias_messages(biases: torch.Tensor,
                           edge_relations: torch.Tensor) -> torch.Tensor:
    """Messages that are the relation's bias vector alone, b[r_e]
    (``relblock.py:170-173``, OnlyBiasGcn)."""
    return take_rows(biases, edge_relations)


def diag_messages(features: torch.Tensor, diags: torch.Tensor,
                  edge_vertices: torch.Tensor,
                  edge_relations: torch.Tensor) -> torch.Tensor:
    """Per-relation diagonal scaling m_e = x[v_e] * D[r_e]
    (``relblock.py:164-167``)."""
    return take_rows(features, edge_vertices) \
        * take_rows(diags, edge_relations)
