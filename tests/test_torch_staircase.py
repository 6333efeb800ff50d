"""The port's staircase_aggregate (TPU kernel 3) and scatter2 /
scatter2_slot_order (TPU kernel 4) on the CPU plain path, against the JAX
package's ops run in Pallas interpret mode, and jax.grad of
staircase_aggregate (its custom VJP; jax.grad does not reach through
scatter2's pallas_call, so scatter2's gradient is held to the gather VJP).

The JAX ops take messages in primary (input) edge order; the port's
staircase_aggregate takes them in the CSR's entry order, so its inputs are
the JAX inputs permuted by ``build_csr``'s ``order`` and its message
gradient is compared with JAX's permuted the same way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationprediction_tpu.ops import staircase as jax_sc
from relationprediction_tpu.ops import staircase2 as jax_s2
from relationprediction_torch import graph as torch_graph
from relationprediction_torch.ops import staircase, staircase2

V, R, E, D = 100, 5, 640, 24
# Both sides sum the same f32 terms in other orders: exact up to that,
# a few ulps of terms of size ~1 in rows of up to ~200 entries.
TOL = dict(rtol=1e-5, atol=1e-5)


def problem(seed):
    """Skewed targets (three hub rows; rows V/2 .. V-1 empty), 10 %
    padding edges (weight 0 or the phantom target V), primary-order
    messages and a cotangent probe."""
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, V // 2, E)
    heavy = rng.random(E) < 0.3
    tgt[heavy] = rng.integers(0, 3, heavy.sum())
    src = rng.integers(0, V, E)
    rel = rng.integers(0, R, E)
    w = (rng.random(E) + 0.1).astype(np.float32)
    pad = rng.random(E) < 0.1
    w[pad & (rng.random(E) < 0.5)] = 0.0
    tgt[pad & (w != 0)] = V
    msgs = rng.standard_normal((E, D)).astype(np.float32)
    probe = rng.standard_normal((V, D)).astype(np.float32)
    return src, rel, tgt, w, msgs, probe


def csr(src, rel, tgt, w):
    layout, order = torch_graph.build_csr(src, rel, tgt, w, V)
    return layout, order


def jax_aggregate_and_grad(msgs, tgt, w, probe):
    layout = jax_sc.build_staircase_layout(tgt, w, V, rb=16, chunk=32)

    def loss(m):
        out = jax_sc.staircase_aggregate(m, layout, V, True)
        return jnp.sum(out * jnp.asarray(probe)), out
    (_, out), grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(msgs))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_staircase_aggregate_and_gradient_match_jax(seed):
    src, rel, tgt, w, msgs, probe = problem(seed)
    want, want_grad = jax_aggregate_and_grad(msgs, tgt, w, probe)
    layout, order = csr(src, rel, tgt, w)
    assert layout.n_edges < E  # the padding edges were dropped
    m = torch.from_numpy(msgs[order]).requires_grad_(True)
    got = staircase.staircase_aggregate(m, layout, V)
    assert got.shape == (V, D)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * torch.from_numpy(probe)).sum().backward()
    # JAX's VJP is a row gather w_e * g[t_e], zero for padding edges
    np.testing.assert_allclose(m.grad.numpy(), want_grad[order], **TOL)
    padding = np.setdiff1d(np.arange(E), order)
    assert not want_grad[padding].any()
    # rows without a real edge come out zero
    empty = layout.row_ptr.diff().numpy() == 0
    assert empty[V // 2:].all()
    assert not got.detach().numpy()[empty].any()


def test_staircase_aggregate_is_the_plain_version_on_cpu():
    src, rel, tgt, w, msgs, _ = problem(2)
    layout, order = csr(src, rel, tgt, w)
    m = torch.from_numpy(msgs[order])
    got = staircase.staircase_aggregate(m, layout, V)
    ref = staircase.staircase_aggregate_reference(m, layout, V)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # the chunks of the plain version do not change its sums' terms
    small = staircase.staircase_aggregate_reference(m, layout, V,
                                                    edge_chunk=37)
    torch.testing.assert_close(small, ref, rtol=1e-6, atol=1e-6)
    # float64 in, float64 out
    exact = staircase.staircase_aggregate_reference(m.double(), layout, V)
    assert exact.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), exact.numpy(), **TOL)


def jax_scatter2(msgs, src, rel, tgt, w):
    layout = jax_s2.build_staircase2_layout(src, rel, tgt, w, V, rb=64,
                                            chunk=128, group=8)
    return np.asarray(jax_s2.scatter2(jnp.asarray(msgs), layout, V,
                                      interpret=True))


def gather_vjp(tgt, w, probe):
    """scatter2's gradient, the standard gather VJP (``staircase2.py:642``:
    jax.grad does not reach through its interpret-mode pallas_call):
    d msgs[e] = w_e * g[t_e] for a real edge, 0 for a padding edge."""
    real = (tgt < V) & (w != 0)
    grad = np.zeros((len(tgt), probe.shape[1]), np.float32)
    grad[real] = w[real, None] * probe[tgt[real]]
    return grad


@pytest.mark.parametrize("seed", [3, 4])
def test_scatter2_and_gradient_match_jax(seed):
    """Primary-order messages with padding edges; the CSR's order is the
    permutation the kernel fuses into its gather."""
    src, rel, tgt, w, msgs, probe = problem(seed)
    want = jax_scatter2(msgs, src, rel, tgt, w)
    layout, order = csr(src, rel, tgt, w)
    m = torch.from_numpy(msgs).requires_grad_(True)
    got = staircase2.scatter2(m, layout, V, order)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), gather_vjp(tgt, w, probe),
                               **TOL)
    padding = np.setdiff1d(np.arange(E), order)
    assert padding.size and not m.grad.numpy()[padding].any()


def test_scatter2_slot_order_takes_weighted_csr_order_messages():
    src, rel, tgt, w, msgs, probe = problem(5)
    want = jax_scatter2(msgs, src, rel, tgt, w)
    layout, order = csr(src, rel, tgt, w)
    weighted = torch.from_numpy(msgs[order] * w[order, None])
    m = weighted.clone().requires_grad_(True)
    got = staircase2.scatter2_slot_order(m, layout, V)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * torch.from_numpy(probe)).sum().backward()
    rows = staircase.row_of_entry(layout).numpy()
    np.testing.assert_array_equal(m.grad.numpy(), probe[rows])


def test_cpu_path_counts_nothing_and_checks_what_the_kernel_takes():
    src, rel, tgt, w, msgs, _ = problem(6)
    layout, order = csr(src, rel, tgt, w)
    counters = (staircase.staircase_aggregate, staircase2.scatter2,
                staircase2.scatter2_slot_order)
    before = [c.launches for c in counters]
    counts = staircase2.launch_counts()
    m = torch.from_numpy(msgs)
    staircase.staircase_aggregate(m[order], layout, V)
    staircase2.scatter2(m, layout, V, order)
    staircase2.scatter2_slot_order(m[order], layout, V)
    assert [c.launches for c in counters] == before
    assert staircase2.launch_counts() == counts
    with pytest.raises(ValueError, match="unsupported device"):
        staircase.staircase_aggregate(m.to("meta"), layout, V)
    # what the wrapper checks before a launch on the card
    good = m[order].contiguous()
    staircase._check(good, layout, V, None)
    staircase._check(m, layout, V,
                     torch.as_tensor(order, dtype=torch.int32))
    for bad, kind in (((good.double(), layout, V, None), TypeError),
                      ((good[:, ::2], layout, V, None), ValueError),
                      ((good[1:], layout, V, None), ValueError),
                      ((good, layout, V + 1, None), ValueError),
                      ((m, layout, V, torch.as_tensor(order)), TypeError),
                      ((m, layout, V, torch.as_tensor(
                          order[1:], dtype=torch.int32)), ValueError)):
        with pytest.raises(kind):
            staircase._check(*bad)


# ---------------------------------------------------------------------------
# The kernel's merge-path partition (csrc/staircase.cu), walked in Python
# ---------------------------------------------------------------------------

def partition_layout(kind):
    """(row_ptr int32, n_rows) of a layout that stresses the partition."""
    rng = np.random.default_rng(len(kind))
    if kind == "hub_holds_every_entry":
        counts = np.zeros(50, np.int64)
        counts[17] = 600
    elif kind == "all_rows_empty":
        counts = np.zeros(40, np.int64)
    elif kind == "empty_runs":  # blocks that hold only row ends
        counts = np.zeros(700, np.int64)
        counts[[0, 3, 350, 699]] = [5, 1, 40, 2]
    elif kind == "rows_of_one_entry":
        counts = np.ones(90, np.int64)
    else:  # a small Zipf-skewed graph: hubs, short rows and empty rows
        counts = np.minimum(rng.zipf(1.6, 300) - 1, 400)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return torch.from_numpy(row_ptr), len(counts)


def walk_merge_path(row_ptr, msgs, w, items):
    """What the kernel does, block by block in block order: each block
    walks its entries in CSR order, writes every row that ends in its range
    once, and keeps its part of the row in progress at its end as a carry;
    then the first slot of each run of carries of one row adds the run in
    block order, then the partial the row's last block wrote."""
    starts, entries = staircase.merge_path_split(row_ptr, items)
    carry_rows = staircase.merge_path_carry_rows(row_ptr, items).tolist()
    rp = row_ptr.tolist()
    out = np.full((len(rp) - 1, msgs.shape[1]), np.nan)
    carries = {}
    for b in range(len(carry_rows)):
        i, (j0, i1, j1) = int(starts[b]), map(
            int, (entries[b], starts[b + 1], entries[b + 1]))
        acc = np.zeros(msgs.shape[1])
        for k in range(j0, j1):
            while k >= rp[i + 1]:
                assert np.isnan(out[i]).all()  # each row written once
                out[i], acc, i = acc, np.zeros_like(acc), i + 1
            acc = acc + w[k] * msgs[k]
        while i < i1:
            assert np.isnan(out[i]).all()
            out[i], acc, i = acc, np.zeros_like(acc), i + 1
        if carry_rows[b] >= 0:
            assert carry_rows[b] == i1 and j1 > rp[i1]
            carries[b] = acc
        else:
            assert i1 == len(rp) - 1 or j1 == rp[i1]
    for b, row in enumerate(carry_rows):
        if row < 0 or (b > 0 and carry_rows[b - 1] == row):
            continue
        total, c = carries[b], b + 1
        while c < len(carry_rows) and carry_rows[c] == row:
            total, c = total + carries[c], c + 1
        out[row] = total + out[row]
    return out


@pytest.mark.parametrize("items", [1, 7, 256])
@pytest.mark.parametrize("kind", ["hub_holds_every_entry", "all_rows_empty",
                                  "empty_runs", "rows_of_one_entry", "zipf"])
def test_merge_path_partition_covers_everything_once_and_sums(kind, items):
    row_ptr, n_rows = partition_layout(kind)
    e = int(row_ptr[-1])
    starts, entries = staircase.merge_path_split(row_ptr, items)
    n_blocks = staircase.merge_path_blocks(n_rows, e, items)
    assert len(starts) == n_blocks + 1
    # the blocks' ranges tile [0, n_rows] row ends and [0, E) entries in
    # order, each block taking `items` of them (the last block the rest)
    assert starts[0] == 0 and entries[0] == 0
    assert starts[-1] == n_rows and entries[-1] == e
    assert (starts.diff() >= 0).all() and (entries.diff() >= 0).all()
    taken = starts.diff() + entries.diff()
    assert (taken[:-1] == items).all() and 0 < taken[-1] <= items
    # every boundary lies on the merge path: rows before it are complete,
    # and the entries taken do not pass the next row's end
    rp = row_ptr.long()
    inner = starts < n_rows
    assert (rp[starts[inner]] <= entries[inner]).all()
    assert (entries[inner] <= rp[starts[inner] + 1]).all()
    # the walk with its carries in block order is the segment sum
    rng = np.random.default_rng(items)
    msgs = rng.standard_normal((e, 6))
    w = rng.random(e) + 0.1
    layout = torch_graph.CsrLayout(
        row_ptr=row_ptr, src=torch.zeros(e, dtype=torch.int32),
        rel=torch.zeros(e, dtype=torch.int32), w=torch.from_numpy(w))
    want = staircase.staircase_aggregate_reference(
        torch.from_numpy(msgs), layout, n_rows).numpy()
    got = walk_merge_path(row_ptr, msgs, w, items)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if kind == "hub_holds_every_entry" and items == 7:
        # the hub spans ~86 blocks, all carrying it but the one it ends in
        carry = staircase.merge_path_carry_rows(row_ptr, items)
        assert (carry == 17).sum() >= 80


def test_merge_path_sizes_raise_beyond_int32():
    assert staircase.merge_path_blocks(10, 0, 256) == 1
    assert staircase.merge_path_blocks(0, 0, 256) == 0
    assert staircase.merge_path_blocks(2 ** 31 - 11, 10, 256) == 2 ** 23
    with pytest.raises(ValueError, match="overflows int32"):
        staircase.merge_path_blocks(2 ** 31 - 5, 10, 256)
    with pytest.raises(ValueError, match="items"):
        staircase.merge_path_blocks(10, 10, 0)


def test_merge_path_items_follow_the_graph_size():
    """512 items a block on the full FB15k-237 graph (14,541 rows, 272,115
    entries), down to 32 where that would leave fewer than 512 blocks (the
    training batch's 15,000 entries)."""
    assert staircase.merge_path_items(14541, 272115) == 512
    assert staircase.merge_path_items(14541, 15000) == 32
    assert staircase.merge_path_items(0, 0) == 32
    for total in (1, 1000, 65536, 10 ** 6):
        items = staircase.merge_path_items(total, 0)
        assert 32 <= items <= 512
        assert items == 32 or staircase.merge_path_blocks(total, 0,
                                                          items) >= 512


@pytest.mark.parametrize("n_src,n_rows", [(90, 30), (30, 90)],
                         ids=["fewer_rows", "more_rows"])
def test_rectangular_layout_forward_and_gradient(n_src, n_rows):
    """Per-edge messages gathered from a table whose rows differ from the
    layout's (a vertex shard's halo buffer and owned rows, or the
    reverse), summed into the layout's rows: the output and d table
    against autograd of the plain version in float64."""
    from relationprediction_torch.ops import relblock
    from test_torch_block_direction_grad import rectangular
    layout, _ = rectangular(n_src, n_rows, 31)
    rng = np.random.default_rng(32)
    table = rng.standard_normal((n_src, D))
    diags = torch.from_numpy(rng.standard_normal((9, D)))
    probe = torch.from_numpy(rng.standard_normal((n_rows, D)))
    t32 = torch.tensor(table, dtype=torch.float32, requires_grad=True)
    msgs = relblock.diag_messages(t32, diags.float(), layout.src, layout.rel)
    out = staircase.staircase_aggregate(msgs, layout, n_rows)
    (out * probe.float()).sum().backward()
    t64 = torch.tensor(table, requires_grad=True)
    want = staircase.staircase_aggregate_reference(
        relblock.diag_messages(t64, diags, layout.src, layout.rel), layout,
        n_rows)
    (want * probe).sum().backward()
    assert out.shape == (n_rows, D) and t32.grad.shape == (n_src, D)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t32.grad.numpy(), t64.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
