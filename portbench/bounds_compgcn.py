"""Least times of the CompGCN step's sums by the merge-path kernel of
``staircase_aggregate`` (the port's TPU kernel 3), from the work their
inputs need.

A step launches it four times: the weighted sums of the two halves'
messages into their targets (d = the layer's width, the layouts' own
entries and weights), and, in the backward, the sums by id of the gathers'
gradients (d = the input width, unweighted, through the permutation of a
CSR by source over the entities and by relation over the 2R relation
rows). Each launch reads each entry's row once, its weight and its
permutation entry where it has them and the row pointers, and writes its
output rows once; 2 E d operations weighted, E d unweighted. The least
time is ``portbench.bounds.least_time`` of them.
"""
from __future__ import annotations

from .bounds import least_time


def sum_bound(n_rows: int, n_entries: int, d: int, weighted: bool,
              permuted: bool) -> dict:
    """One launch: ``n_entries`` rows of ``d`` float32 into ``n_rows``."""
    n_bytes = 4 * (n_entries * d + n_rows * d + n_rows + 1
                   + n_entries * (int(weighted) + int(permuted)))
    ops = (2 if weighted else 1) * n_entries * d
    return least_time(n_bytes, ops)


def step_launches(graph, d_in: int, d: int) -> list:
    """The four launches of a step on ``graph`` (the port's
    ``CompGCNGraph``, or any object with ``inward`` / ``outward`` layouts
    (``n_rows``, ``n_edges``), ``n_vertices`` and ``n_relations``), each
    (n_rows, n_entries, d, weighted, permuted)."""
    entries = graph.inward.n_edges + graph.outward.n_edges
    return [(graph.n_vertices, graph.inward.n_edges, d, True, False),
            (graph.n_vertices, graph.outward.n_edges, d, True, False),
            (graph.n_vertices, entries, d_in, False, True),
            (2 * graph.n_relations, entries, d_in, False, True)]


def step_least_s(launches: list) -> float:
    return sum(sum_bound(*launch)["bound_s"] for launch in launches)
