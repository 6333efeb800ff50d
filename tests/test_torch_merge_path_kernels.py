"""The merge-path partitions of block_direction_f32 (forward and twin) and
basis_combine_f32 (csrc/block_direction.cu, csrc/basis_direction.cu on
csrc/merge_path.cuh), walked in Python as the kernels walk them, against
the port's plain versions in float64 and against the JAX package's
staircase2.block_direction / basis_direction in Pallas interpret mode (and
jax.grad of them for the twin pass); the items rules; the range check of
scatter2's permutation; the build hash of ops/nvcc.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_basis_direction as tbs
import test_torch_block_direction as tbd
import test_torch_block_direction_grad as tbg
from relationprediction_tpu.ops import staircase2 as jax_s2
from relationprediction_torch import graph as torch_graph
from relationprediction_torch.ops import nvcc, staircase, staircase2
from test_torch_staircase import partition_layout

LAYOUTS = ["hub_holds_every_entry", "all_rows_empty", "empty_runs",
           "rows_of_one_entry", "zipf", "run_across_blocks"]
N_SRC, N_REL = 30, 4            # walk layouts: source rows, relations
N_BLOCKS, DR = 3, 2             # block kernel: d = 6
N_BASES, D_OUT = 3, 5           # combine kernel


def walk_kernel(row_ptr, items, n_cols, term, run_of=None, close=None):
    """What a merge-path kernel does, block by block in block order: each
    block walks its entries in CSR order and writes every row that ends in
    its range once, keeping its part of the row in progress at its end as
    a carry; then the first slot of each run of carries of one row adds
    the run in block order, then the partial the row's last block wrote.
    An entry adds ``term(k)``; with ``run_of``, the terms of a relation run
    (consecutive entries of a row with one ``run_of(k)``) are summed first
    and ``close(z, run)`` adds the run's product when it ends: at a change
    of run, at the row's end and at the block's end, so a run cut by a
    block boundary is closed in each part."""
    starts, entries = staircase.merge_path_split(row_ptr, items)
    carry_rows = staircase.merge_path_carry_rows(row_ptr, items).tolist()
    rp = row_ptr.tolist()
    n_rows = len(rp) - 1
    out = np.full((n_rows, n_cols), np.nan)
    zero = np.zeros(n_cols)
    carries, cut_runs = {}, 0
    for b in range(len(carry_rows)):
        i, j0, i1, j1 = (int(t) for t in (starts[b], entries[b],
                                          starts[b + 1], entries[b + 1]))
        y, z, run = zero, zero, None
        for k in range(j0, j1):
            while k >= rp[i + 1]:  # row i ends before entry k
                if run is not None:
                    y = y + close(z, run)
                assert np.isnan(out[i]).all()  # each row written once
                out[i], y, z, run, i = y, zero, zero, None, i + 1
            if run_of is None:
                y = y + term(k)
                continue
            if run_of(k) != run:
                if run is not None:
                    y = y + close(z, run)
                z, run = zero, run_of(k)
            z = z + term(k)
        if run is not None:
            y = y + close(z, run)
            cut_runs += carry_rows[b] >= 0
        while i < i1:
            assert np.isnan(out[i]).all()
            out[i], y, i = y, zero, i + 1
        if carry_rows[b] >= 0:
            assert carry_rows[b] == i1 and j1 > rp[i1]
            carries[b] = y
        else:
            assert i1 == n_rows or j1 == rp[i1]
    for b, row in enumerate(carry_rows):
        if row < 0 or (b > 0 and carry_rows[b - 1] == row):
            continue
        total, c = carries[b], b + 1
        while c < len(carry_rows) and carry_rows[c] == row:
            total, c = total + carries[c], c + 1
        out[row] = total + out[row]
    return out, cut_runs


def block_walk(layout, x, blocks, items):
    """block_direction_f32's walk: z = sum w_e x[src_e] over a relation
    run, then y += blockdiag(W[r]) @ z (``blocks`` as given; transposed
    for the twin pass)."""
    src, rel, w = (t.numpy() for t in (layout.src, layout.rel, layout.w))
    n_blocks, dr = blocks.shape[1], blocks.shape[2]

    def close(z, r):
        return np.einsum("bij,bj->bi", blocks[r],
                         z.reshape(n_blocks, dr)).reshape(-1)
    return walk_kernel(layout.row_ptr, items, n_blocks * dr,
                       lambda k: w[k] * x[src[k]], lambda k: rel[k], close)


def combine_walk(layout, proj, coef, items):
    """basis_combine_f32's walk: each entry adds its B values w_e C[r_e, b]
    times its P row's B parts."""
    src, rel, w = (t.numpy() for t in (layout.src, layout.rel, layout.w))
    n_bases = coef.shape[1]
    parts = proj.reshape(proj.shape[0], n_bases, -1)
    return walk_kernel(
        layout.row_ptr, items, parts.shape[2],
        lambda k: np.einsum("b,bo->o", w[k] * coef[rel[k]], parts[src[k]]))


def walk_layout(kind):
    """A CSR of one of partition_layout's row-length patterns (or a
    300-entry row in one relation, "run_across_blocks"), with sources
    uniform over N_SRC rows, relations ascending within each row, and
    weights in [0.1, 1.1)."""
    if kind == "run_across_blocks":
        counts = np.zeros(60, np.int64)
        counts[[5, 6, 40]] = [300, 3, 20]
        row_ptr = torch.from_numpy(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    else:
        row_ptr, _ = partition_layout(kind)
    e = int(row_ptr[-1])
    rng = np.random.default_rng(len(kind) + 50)
    rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr.numpy()))
    rel = rng.integers(0, N_REL, e)
    if kind == "run_across_blocks":
        rel[rows == 5] = 2
    rel = rel[np.lexsort((rel, rows))]
    return torch_graph.CsrLayout(
        row_ptr=row_ptr,
        src=torch.from_numpy(rng.integers(0, N_SRC, e).astype(np.int32)),
        rel=torch.from_numpy(rel.astype(np.int32)),
        w=torch.from_numpy(rng.random(e) + 0.1))


@pytest.mark.parametrize("items", [1, 7, 64])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_block_direction_walk_is_the_plain_sum(kind, items):
    layout = walk_layout(kind)
    rng = np.random.default_rng(items)
    x = rng.standard_normal((N_SRC, N_BLOCKS * DR))
    blocks = rng.standard_normal((N_REL, N_BLOCKS, DR, DR))
    want = staircase2.block_direction_reference(
        torch.from_numpy(x), torch.from_numpy(blocks), layout,
        layout.n_rows).numpy()
    got, cut_runs = block_walk(layout, x, blocks, items)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if kind == "run_across_blocks" and items < 300:
        # the 300-entry run of row 5 is cut: W[2] applies in every part
        assert cut_runs >= 300 // (items + 1)


@pytest.mark.parametrize("items", [1, 7, 64])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_basis_combine_walk_is_the_plain_sum(kind, items):
    layout = walk_layout(kind)
    rng = np.random.default_rng(items + 1)
    proj = rng.standard_normal((N_SRC, N_BASES * D_OUT))
    coef = rng.standard_normal((N_REL, N_BASES))
    want = staircase2.basis_combine_reference(
        torch.from_numpy(proj), torch.from_numpy(coef), layout,
        layout.n_rows).numpy()
    got, _ = combine_walk(layout, proj, coef, items)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("items", [7, None])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_block_direction_walk_matches_jax(direction, items):
    """On the padded edge list of test_torch_block_direction, at 7 items a
    block and at the rule's."""
    senders, relations, receivers, weights = tbd.edge_list(0)
    x, blocks = tbd.inputs(0, 4, 5)
    pair = jax_s2.build_staircase2_pair(
        senders, relations, receivers, weights, tbd.V, direction=direction,
        rb=64, chunk=128, k=2, group=8)
    want = np.asarray(jax_s2.block_direction(
        jnp.asarray(x), jnp.asarray(blocks), pair, 4, tbd.V,
        interpret=True, compute_dtype=None))
    src, tgt = ((senders, receivers) if direction == "forward"
                else (receivers, senders))
    layout, _ = torch_graph.build_csr(src, relations, tgt, weights, tbd.V)
    if items is None:
        items = staircase.block_direction_items(tbd.V, layout.n_edges)
    got, _ = block_walk(layout, x.astype(np.float64),
                        blocks.astype(np.float64), items)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_block_direction_twin_walk_matches_jax_grad(direction):
    """The twin pass (blocks transposed, on the direction's twin CSR) at
    the rule's items is jax.grad's d features."""
    triples = tbg.skewed_triples(0)
    x, blocks, probe = tbg.dense_inputs(0)
    jg = tbg.jax_graph.build_graph_batch(triples, tbg.V, tbg.R, pad_to=512,
                                         staircase2=True, s2_rb=64,
                                         s2_chunk=128)
    tg = torch_graph.build_graph_batch(triples, tbg.V, tbg.R)
    pair, twin = ((jg.sc2_fwd, tg.fwd_twin) if direction == "forward"
                  else (jg.sc2_bwd, tg.bwd_twin))
    want, _ = tbg.jax_grads(x, blocks, probe, pair)
    items = staircase.block_direction_items(tbg.V, twin.n_edges)
    got, _ = block_walk(twin, probe.astype(np.float64),
                        blocks.astype(np.float64).swapaxes(-1, -2), items)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_basis_combine_walk_matches_jax(direction):
    """Forward: the walk on P = x @ W_flat is JAX's basis_direction; twin:
    the walk on Q = g @ w_t over the twin CSR is jax.grad's d features."""
    triples, jg, tg = tbs.graphs(1)
    x, w_flat, coef, probe = (a.astype(np.float64)
                              for a in tbs.dense_inputs(1))
    pair, layout, twin, _ = tbs.layouts(jg, tg, direction)
    want = np.asarray(jax_s2.basis_direction(
        *(jnp.asarray(a, jnp.float32) for a in (x, w_flat, coef)), pair,
        tbs.N_BASES, tbs.V, True, None))
    got, _ = combine_walk(layout, x @ w_flat, coef,
                          staircase.basis_combine_items(tbs.V,
                                                        layout.n_edges))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    want_dx = tbs.jax_grads(*(a.astype(np.float32)
                              for a in (x, w_flat, coef, probe)), pair)[0]
    w_t = staircase2.basis_twin_weights(torch.from_numpy(w_flat),
                                        tbs.N_BASES).numpy()
    got_dx, _ = combine_walk(twin, probe @ w_t, coef,
                             staircase.basis_combine_items(tbs.V,
                                                           twin.n_edges))
    np.testing.assert_allclose(got_dx, want_dx, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rule,full,train,least,most", [
    (staircase.block_direction_items, 64, 32, 32, 64),
    (staircase.basis_combine_items, 128, 32, 16, 128)])
def test_kernel_items_rules_follow_the_graph_size(rule, full, train, least,
                                                  most):
    """Each kernel's items a block on the full FB15k-237 graph (14,541
    rows, 272,115 entries) and at the training batch's 15,000 entries;
    elsewhere within [least, most], at least 512 blocks unless at
    least."""
    assert rule(14541, 272115) == full
    assert rule(14541, 15000) == train
    assert rule(0, 0) == least
    for total in (1, 1000, 65536, 10 ** 6):
        items = rule(total, 0)
        assert least <= items <= most
        assert items == least or staircase.merge_path_blocks(
            total, 0, items) >= 512


def test_carry_buffers_follow_the_partition_and_the_kernels_limit():
    rows, carry = staircase2._carry_buffers(100, 1000, 64, 6, 1024, "cpu")
    assert rows.dtype == torch.int32 and carry.dtype == torch.float32
    assert rows.shape == (18,) and carry.shape == (18, 6)
    with pytest.raises(ValueError, match="items <= 1024"):
        staircase2._carry_buffers(100, 1000, 2048, 6, 1024, "cpu")


@pytest.mark.parametrize("bad", [-1, 40])
def test_scatter2_refuses_an_order_outside_the_messages(bad):
    """Both paths refuse what the card's kernel would skip: the CPU plain
    path (which would raise IndexError for 40 and wrap -1 to a real row),
    and, before any copy to the card, a host order for another device
    (here "meta", which has no values to check)."""
    msgs = torch.randn(40, 3)
    layout, order = torch_graph.build_csr(np.arange(40) % 7, np.zeros(40),
                                          np.arange(40) % 5,
                                          np.ones(40, np.float32), 7)
    order = order.copy()
    staircase2.scatter2(msgs, layout, 7, order)
    order[3] = bad
    for m in (msgs, msgs.to("meta")):
        with pytest.raises(ValueError, match="outside"):
            staircase2.scatter2(m, layout, 7, order)


def test_build_hash_covers_the_included_headers(tmp_path):
    """A library is named by the source, the headers beside it and the
    flags: editing an included header names a new build."""
    src = tmp_path / "kernel.cu"
    header = tmp_path / "shared.cuh"
    src.write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    header.write_text("#pragma once\nconstexpr int kItems = 256;\n")
    first = nvcc.source_digest(src)
    assert nvcc.source_digest(src) == first
    header.write_text("#pragma once\nconstexpr int kItems = 512;\n")
    assert nvcc.source_digest(src) != first
    # the port's own sources hash their merge_path.cuh
    assert (nvcc.CSRC / "merge_path.cuh").exists()
