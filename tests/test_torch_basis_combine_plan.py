"""The chunk route of basis_combine_bf16 (csrc/basis_direction.cu's
combine_chunk_kernel) on the host: the route and column chunks that
staircase.basis_combine_plan computes from the shapes (every column in one
chunk, chunks a whole number of words of at most a group's threads, as
few as that allows, d_out a multiple of 4 or not), and the kernel's order
(column chunks, then thread blocks of consecutive merge-path parts, one
part a group, then the carry fix-up) walked in Python as the kernel walks
it, against the walk of basis_combine_f32
(test_torch_merge_path_kernels.combine_walk): the same terms in the same
order, so the same bits, and the same carry rows, on square and
rectangular layouts and at B = 1..8; and against the JAX package's basis_direction in
Pallas interpret mode. A bf16 CPU tensor takes the plain version and
moves no counter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_basis_direction as tbs
from relationprediction_tpu.ops import staircase2 as jax_s2
from relationprediction_torch.graph import build_csr
from relationprediction_torch.ops import staircase, staircase2
from test_torch_block_direction_grad import rectangular
from test_torch_merge_path_kernels import (LAYOUTS, N_BASES, N_REL, N_SRC,
                                           combine_walk, walk_layout)

COUNTERS = ("launches", "twin_launches", "bf16_launches",
            "bf16_twin_launches", "bf16_chunk_launches",
            "bf16_twin_chunk_launches", "bf16_row_launches",
            "bf16_twin_row_launches", "fixup_launches")


@pytest.mark.parametrize("d_out", [1, 4, 6, 37, 128, 129, 500, 512, 513,
                                   516, 1000, 2048, 4099])
def test_chunks_cover_every_column_once(d_out):
    """Every column in exactly one chunk, in order; chunks of whole words
    (4 columns where d_out % 4 == 0, else 1) of at most a group's threads,
    as few as that allows, evened out: each of the same words but the
    last, which takes the rest."""
    plan = staircase.basis_combine_plan(d_out)
    assert plan.route == "chunk"
    assert plan.cols == (4 if d_out % 4 == 0 else 1)
    words = d_out // plan.cols
    chunk_words = plan.chunk_cols // plan.cols
    assert plan.chunk_cols % plan.cols == 0
    assert 1 <= chunk_words <= staircase.COMBINE_CHUNK_THREADS
    chunks = plan.chunks(d_out)
    assert len(chunks) == plan.n_chunks
    assert [c for first, end in chunks for c in range(first, end)] == \
        list(range(d_out))
    assert all(first % plan.cols == 0 and first < end
               for first, end in chunks)
    assert plan.n_chunks == -(-words // staircase.COMBINE_CHUNK_THREADS)
    assert chunk_words == -(-words // plan.n_chunks)


def test_gcn_basis_plan():
    """gcn_basis.exp (d_out = 500): one chunk of 125 4-column words; d_out
    = 1,000, two of 500 columns; f32 P keeps PR 6's whole rows."""
    assert staircase.basis_combine_plan(500) == \
        staircase.CombinePlan("chunk", 4, 500, 1)
    assert staircase.basis_combine_plan(1000).chunks(1000) == \
        [(0, 500), (500, 1000)]
    assert staircase.basis_combine_plan(500, 4) == \
        staircase.CombinePlan("row")


def chunk_walk(layout, proj, coef, items, plan, groups):
    """What combine_chunk_kernel does, thread block by thread block in
    grid order (chunk by chunk, then ``groups`` consecutive parts a
    block): the block finds the merge path at each of its group
    boundaries; each group walks its part's entries in CSR order over its
    chunk's columns, writes each row that ends in its part once and keeps
    the row in progress at its end as the part's carry (carry_row from
    chunk 0 alone); a group past the last part has nothing. Then the
    fix-up over all columns: carries of a row in part order, then the
    partial its last part wrote. An entry adds the same term as
    combine_walk's. Returns (out, carry_rows)."""
    src, rel, w = (t.numpy() for t in (layout.src, layout.rel, layout.w))
    n_bases = coef.shape[1]
    parts = proj.reshape(proj.shape[0], n_bases, -1)
    d_out = parts.shape[2]
    rp = layout.row_ptr.tolist()
    n_rows, n_edges = len(rp) - 1, rp[-1]
    total = n_rows + n_edges
    n_parts = staircase.merge_path_blocks(n_rows, n_edges, items)
    keys = np.asarray(rp[1:], np.int64) + np.arange(n_rows)
    out = np.full((n_rows, d_out), np.nan)
    carry = np.full((n_parts, d_out), np.nan)
    carry_rows = np.full(n_parts, -2, np.int64)
    per_chunk = -(-n_parts // groups)
    for block in range(per_chunk * plan.n_chunks):
        chunk, part0 = block // per_chunk, (block % per_chunk) * groups
        c0, c1 = plan.chunks(d_out)[chunk]
        bounds = []
        for t in range(groups + 1):
            diag = min((part0 + t) * items, total)
            i = int(np.searchsorted(keys, diag, side="left"))
            bounds.append((i, diag - i, i < n_rows and diag - i > rp[i]))
        for g in range(groups):
            (i0, j0, _), (i1, j1, has_carry) = bounds[g], bounds[g + 1]
            n_ends = i1 - i0
            acc, r = np.zeros(c1 - c0), 0
            row_end = rp[i0 + 1] if n_ends > 0 else np.inf
            for k in range(j0, j1):
                while k >= row_end:  # row i0 + r ends before entry k
                    assert np.isnan(out[i0 + r, c0:c1]).all()
                    out[i0 + r, c0:c1], acc, r = acc, np.zeros(c1 - c0), r + 1
                    row_end = rp[i0 + r + 1] if r < n_ends else np.inf
                acc = acc + np.einsum("b,bo->o", w[k] * coef[rel[k]],
                                      parts[src[k]])[c0:c1]
            while r < n_ends:
                assert np.isnan(out[i0 + r, c0:c1]).all()
                out[i0 + r, c0:c1], acc, r = acc, np.zeros(c1 - c0), r + 1
            part = part0 + g
            if part >= n_parts:
                assert (i0, j0) == (i1, j1) == (n_rows, n_edges)
                continue
            if chunk == 0:
                assert carry_rows[part] == -2  # each part walked once
                carry_rows[part] = i1 if has_carry else -1
            if has_carry:
                carry[part, c0:c1] = acc
            else:
                assert not np.any(acc)
    assert (carry_rows >= -1).all()
    for b, row in enumerate(carry_rows):
        if row < 0 or (b > 0 and carry_rows[b - 1] == row):
            continue
        acc, c = carry[b], b + 1
        while c < n_parts and carry_rows[c] == row:
            acc, c = acc + carry[c], c + 1
        out[row] = acc + out[row]
    return out, carry_rows


# (columns a thread, columns a chunk) at D_OUT = 8: 4-column words in
# chunks of one word, single columns in chunks of 3 (the last 2) and of all
# 8; thread blocks of one group and of the kernel's 4 (the last block's
# groups past the last part idle).
PLANS = [(4, 4), (1, 3), (1, 8)]
GROUPS = [1, 4]
D_OUT = 8


def plan_of(cols, chunk_cols, d_out):
    return staircase.CombinePlan("chunk", cols, chunk_cols,
                                 -(-d_out // chunk_cols))


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("cols, chunk_cols", PLANS)
@pytest.mark.parametrize("items", [1, 7, 64])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_chunk_walk_gives_the_f32_walks_bits(kind, items, cols, chunk_cols,
                                             groups):
    layout = walk_layout(kind)
    rng = np.random.default_rng(items + chunk_cols + groups)
    proj = rng.standard_normal((N_SRC, N_BASES * D_OUT))
    coef = rng.standard_normal((N_REL, N_BASES))
    got, carry_rows = chunk_walk(layout, proj, coef, items,
                                 plan_of(cols, chunk_cols, D_OUT), groups)
    want, _ = combine_walk(layout, proj, coef, items)
    assert np.array_equal(got, want)
    assert np.array_equal(carry_rows, staircase.merge_path_carry_rows(
        layout.row_ptr, items).numpy())


@pytest.mark.parametrize("n_src, n_rows", [(90, 30), (30, 90)],
                         ids=["fewer_rows", "more_rows"])
def test_chunk_walk_on_rectangular_layouts(n_src, n_rows):
    """A vertex shard's layouts (rows from a halo buffer of other length;
    the twin the reverse), by the plan for their shapes at d_out = 37 (one
    column a thread) and 8 (4-column words): in chunks of one word and 4
    parts a block, the f32 walk's bits; by the plan at the items rule's,
    the plain version's sums."""
    layout, twin = rectangular(n_src, n_rows, 31)
    rng = np.random.default_rng(32)
    for lay, src_rows in ((layout, n_src), (twin, n_rows)):
        for d_out in (37, 8):
            proj = rng.standard_normal((src_rows, N_BASES * d_out))
            coef = rng.standard_normal((tbs.R, N_BASES))
            plan = staircase.basis_combine_plan(d_out)
            items = staircase.basis_combine_items(lay.n_rows, lay.n_edges)
            got, _ = chunk_walk(lay, proj, coef, 3, plan_of(
                plan.cols, plan.cols, d_out), 4)
            want, _ = combine_walk(lay, proj, coef, 3)
            assert np.array_equal(got, want)
            got, _ = chunk_walk(lay, proj, coef, items, plan, 1)
            ref = staircase2.basis_combine_reference(
                torch.from_numpy(proj), torch.from_numpy(coef), lay,
                lay.n_rows).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_bases", range(1, 9))
def test_chunk_walk_at_every_basis_count(n_bases):
    """B = 1..8 (the kernel's range), by the plan at d_out = 8 and in
    chunks of 3 single columns, 4 parts a block: the f32 walk's bits."""
    layout = walk_layout("zipf")
    rng = np.random.default_rng(40 + n_bases)
    proj = rng.standard_normal((N_SRC, n_bases * D_OUT))
    coef = rng.standard_normal((N_REL, n_bases))
    want, _ = combine_walk(layout, proj, coef, 7)
    for plan in (staircase.basis_combine_plan(D_OUT), plan_of(1, 3, D_OUT)):
        got, _ = chunk_walk(layout, proj, coef, 7, plan, 4)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("cols, chunk_cols", [(4, 4), (1, 3)])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_chunk_walk_matches_jax(direction, cols, chunk_cols):
    """Forward: the chunk walk on P = x @ W_flat is JAX's basis_direction;
    twin: on Q = g @ w_t over the twin CSR, jax.grad's d features; at the
    items rule's, in chunks of one 4-column word and in chunks of 3
    single columns (the last shorter; 16 columns forward, 12 twin)."""
    triples, jg, tg = tbs.graphs(1)
    x, w_flat, coef, probe = (a.astype(np.float64)
                              for a in tbs.dense_inputs(1))
    pair, layout, twin, _ = tbs.layouts(jg, tg, direction)
    want = np.asarray(jax_s2.basis_direction(
        *(jnp.asarray(a, jnp.float32) for a in (x, w_flat, coef)), pair,
        tbs.N_BASES, tbs.V, True, None))
    got, _ = chunk_walk(layout, x @ w_flat, coef,
                        staircase.basis_combine_items(tbs.V, layout.n_edges),
                        plan_of(cols, chunk_cols, tbs.D_OUT), 4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    want_dx = tbs.jax_grads(*(a.astype(np.float32)
                              for a in (x, w_flat, coef, probe)), pair)[0]
    w_t = staircase2.basis_twin_weights(torch.from_numpy(w_flat),
                                        tbs.N_BASES).numpy()
    got_dx, _ = chunk_walk(twin, probe @ w_t, coef,
                           staircase.basis_combine_items(tbs.V,
                                                         twin.n_edges),
                           plan_of(cols, chunk_cols, tbs.D_IN), 4)
    np.testing.assert_allclose(got_dx, want_dx, rtol=2e-4, atol=2e-4)


def test_combine_route_follows_the_dtype():
    coef = torch.zeros(237, 5)
    assert staircase2.combine_route(
        torch.zeros(3, 2500, dtype=torch.bfloat16), coef) == "chunk"
    assert staircase2.combine_route(torch.zeros(3, 2500), coef) == "row"


def test_launch_refuses_a_route_the_plan_has_not():
    """``route="chunk"`` raises for f32 P, an unknown route for either,
    before the library is touched."""
    layout, _ = build_csr([0], [0], [1], [1.0], 2)
    coef = torch.zeros(1, 2)
    for proj, route in ((torch.zeros(2, 8), "chunk"),
                        (torch.zeros(2, 8), "sideways"),
                        (torch.zeros(2, 8, dtype=torch.bfloat16), "column")):
        with pytest.raises(ValueError, match=f"no '{route}' route"):
            staircase2.launch_combine(None, proj, coef, layout, 2,
                                      route=route)


@pytest.mark.parametrize("twin", [False, True])
def test_bf16_cpu_tensor_takes_the_plain_version(twin):
    """compute_dtype bf16 on CPU tensors: the plain version on the
    bf16-rounded P, forward and twin pass, and no counter moves."""
    rng = np.random.default_rng(5)
    n, n_rel, d_in, d_out = 12, 3, 6, 8
    senders = rng.integers(0, n, 40)
    receivers = rng.integers(0, n, 40)
    relations = rng.integers(0, n_rel, 40)
    weights = rng.random(40) + 0.1
    layout, order = build_csr(senders, relations, receivers, weights, n)
    twin_layout, _ = build_csr(receivers[order], relations[order],
                               senders[order], weights[order], n)
    x = torch.from_numpy(rng.standard_normal((n, d_in))).float()
    w_flat = torch.from_numpy(
        rng.standard_normal((d_in, N_BASES * d_out))).float()
    coef = torch.from_numpy(rng.standard_normal((n_rel, N_BASES))).float()
    before = {k: getattr(staircase2.basis_direction, k) for k in COUNTERS}
    f = x.clone().requires_grad_(twin)
    out = staircase2.basis_direction(f, w_flat, coef, layout, n, twin_layout,
                                     compute_dtype=torch.bfloat16)
    p16 = staircase2.basis_project_reference(x.to(torch.bfloat16),
                                             w_flat.to(torch.bfloat16))
    want = staircase2.basis_combine_reference(p16, coef, layout, n)
    assert out.dtype == torch.float32 and torch.equal(out, want)
    if twin:
        out.backward(torch.ones_like(out))
        assert f.grad.shape == x.shape
    assert {k: getattr(staircase2.basis_direction, k)
            for k in COUNTERS} == before
