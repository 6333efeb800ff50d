"""The port's CSR graph layout against the JAX package's GraphBatch."""
import os

import numpy as np
import pytest
import torch

from relationprediction_tpu import graph as jax_graph
from relationprediction_tpu.data import synthetic as jax_synthetic
from relationprediction_torch import graph as torch_graph
from relationprediction_torch.data import dataset as torch_dataset

TOY = os.path.join(os.path.dirname(__file__), "..", "data", "Toy")


def graphs(name, padded):
    """JAX's GraphBatch (padded to a multiple of 128 edges, or not) and the
    port's, for one dataset."""
    if name == "toy":
        ds = torch_dataset.load(TOY)
    else:
        ds = jax_synthetic.generate(300, 11, 1500, seed=0)
    v, r = ds.n_entities, ds.n_relations
    pad = -(-len(ds.train) // 128) * 128 if padded else None
    jg = jax_graph.build_graph_batch(ds.train, v, r, pad_to=pad)
    tg = torch_graph.build_graph_batch(ds.train, v, r)
    return jg, tg


def csr_edges(layout):
    """(target, relation, source, weight) per CSR entry, in CSR order."""
    row_ptr = layout.row_ptr.numpy()
    tgt = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    return np.stack([tgt, layout.rel.numpy(), layout.src.numpy(),
                     layout.w.numpy().astype(np.float64)], axis=1)


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("name", ["toy", "synthetic"])
def test_csr_holds_each_real_edge_once_with_jax_weight(name, padded):
    jg, tg = graphs(name, padded)
    assert (tg.n_vertices, tg.n_relations) == (jg.n_vertices,
                                               jg.n_relations)
    s, r, o = (np.asarray(jg.senders), np.asarray(jg.relations),
               np.asarray(jg.receivers))
    real = np.asarray(jg.mask) > 0
    for layout, tgt, src, norm in (
            (tg.fwd, o, s, np.asarray(jg.fwd_norm)),
            (tg.bwd, s, o, np.asarray(jg.bwd_norm))):
        want = np.stack([tgt[real], r[real], src[real],
                         norm[real].astype(np.float64)], axis=1)
        got = csr_edges(layout)
        assert got.shape == want.shape
        order_w = np.lexsort(want.T[::-1])
        order_g = np.lexsort(got.T[::-1])
        np.testing.assert_array_equal(got[order_g], want[order_w])
        # sorted by (target, relation): targets and, within a row,
        # relations never decrease
        key = got[:, 0] * (tg.n_relations + 1) + got[:, 1]
        assert np.all(np.diff(key) >= 0)
        assert layout.row_ptr.dtype == torch.int32
        assert layout.src.dtype == layout.rel.dtype == torch.int32


def test_padding_and_bad_input_are_dropped_or_refused():
    tri = np.array([[0, 1, 2], [2, 0, 1]], dtype=np.int32)
    g = torch_graph.build_graph_batch(tri, 4, 2)
    assert g.fwd.n_edges == g.bwd.n_edges == 2
    assert g.fwd.n_rows == 4 and int(g.fwd.row_ptr[-1]) == 2
    # padding edges (weight 0, or a target at or past V) are dropped
    layout, order = torch_graph.build_csr([0, 1, 4], [0, 1, 0], [1, 2, 4],
                                          [1.0, 0.0, 0.0], 4)
    assert layout.n_edges == 1 and layout.row_ptr.tolist() == [0, 0, 1, 1, 1]
    assert order.tolist() == [0]
    with pytest.raises(ValueError):
        torch_graph.build_csr([5], [0], [1], [1.0], 4)  # source >= V
    with pytest.raises(ValueError):
        torch_graph.build_graph_batch(tri, 4, 1)  # relation 1 >= R
    with pytest.raises(ValueError):
        torch_graph.build_graph_batch(tri, 4, 2, normalization="degree")


def test_graph_to_keeps_counts_and_values():
    tri = np.array([[0, 1, 2], [2, 0, 1], [3, 1, 2]], dtype=np.int32)
    g = torch_graph.build_graph_batch(tri, 4, 2)
    h = g.to("cpu")
    assert (h.n_vertices, h.n_relations) == (4, 2)
    assert torch.equal(h.bwd.row_ptr, g.bwd.row_ptr)
    # receiver 2 has in-degree 2: its forward weights are 1/2
    np.testing.assert_allclose(g.fwd.w.numpy(), [1.0, 0.5, 0.5])


def test_build_csr_checks_sources_against_their_own_count():
    """A rectangular layout (``n_sources`` != its rows): sources are held
    to [0, n_sources), targets to the rows; the kernels read ``src`` with
    no check on the device, so this is the guard."""
    layout, _ = torch_graph.build_csr([5, 0], [0, 1], [1, 2], [1.0, 0.5], 3,
                                      n_sources=6)
    assert (layout.n_rows, layout.source_rows, layout.n_sources) == (3, 6, 6)
    assert layout.src.tolist() == [5, 0]
    assert layout.to("cpu").n_sources == 6
    with pytest.raises(ValueError, match=r"source outside \[0, 6\)"):
        torch_graph.build_csr([6], [0], [1], [1.0], 3, n_sources=6)
    with pytest.raises(ValueError, match=r"source outside \[0, 3\)"):
        torch_graph.build_csr([5], [0], [1], [1.0], 3)
    # fewer sources than rows; a padding edge's source is not checked
    layout, _ = torch_graph.build_csr([1, 7], [0, 0], [4, 2], [1.0, 0.0], 5,
                                      n_sources=2)
    assert (layout.n_edges, layout.source_rows) == (1, 2)
    with pytest.raises(ValueError, match=r"source outside \[0, 2\)"):
        torch_graph.build_csr([2], [0], [4], [1.0], 5, n_sources=2)
    square, _ = torch_graph.build_csr([0], [0], [1], [1.0], 3)
    assert square.n_sources is None and square.source_rows == 3
