"""The port's row gather (``ops/gather.take_rows``) and sum by id
(``id_csr``, ``sum_by_csr``, ``add_by_id``) on the CPU.

take_rows' gradient is held to a float64 per-id sum within the rounding
of a sequential sum in the cotangent's dtype: an id with c rows of
cotangent g differs by at most (c + 1) * u * sum |g| (u the unit
roundoff, 2^-24 for float32, 2^-8 for bf16: each add rounds once, to at
most u of a partial sum no larger than sum |g|, and bf16's result is
rounded once more). Against autograd's ``table[ids]`` gradient, the
same sum in another order, it is within twice that. It is also the JAX
package's scatter-add bit for bit (the sum it stands for), and one sum
however many times it runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationprediction_torch.graph import CsrLayout
from relationprediction_torch.ops import gather, staircase

BF16 = torch.bfloat16
UNIT = {torch.float32: 2.0 ** -24, BF16: 2.0 ** -8}


def draw(n_rows, n_ids, width, dtype, seed=0, id_shape=None):
    """(table [n_ids, width], ids of id_shape (or [n_rows]), cotangent of
    the gathered rows), ids skewed so that some repeat often and id
    n_ids - 1 is never used."""
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.5, n_rows) - 1, n_ids - 2)
    ids = ids.reshape(id_shape or (n_rows,))
    table = torch.from_numpy(rng.standard_normal((n_ids, width))
                             .astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(ids.shape + (width,))
                         .astype(np.float32)).to(dtype)
    return table, torch.from_numpy(ids), g


def per_id_sum(ids, g, n_ids):
    """(float64 sum, float64 sum of |g|, row count) per id."""
    flat_ids = ids.reshape(-1).numpy()
    rows = g.reshape(flat_ids.shape[0], -1).double().numpy()
    total = np.zeros((n_ids, rows.shape[1]))
    mag = np.zeros_like(total)
    np.add.at(total, flat_ids, rows)
    np.add.at(mag, flat_ids, np.abs(rows))
    return total, mag, np.bincount(flat_ids, minlength=n_ids)[:, None]


def take_rows_grad(table, ids, g):
    leaf = table.clone().requires_grad_(True)
    out = gather.take_rows(leaf, ids)
    out.backward(g)
    return out.detach(), leaf.grad


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("id_shape", [(3000,), (300, 10)])
def test_take_rows_gradient_is_the_per_id_sum(dtype, id_shape):
    n_ids, width = 40, 24
    table, ids, g = draw(3000, n_ids, width, dtype, id_shape=id_shape)
    out, grad = take_rows_grad(table, ids, g)
    assert out.dtype == dtype and torch.equal(out, table[ids])
    assert grad.dtype == dtype and grad.shape == table.shape
    exact, mag, count = per_id_sum(ids, g, n_ids)
    bound = (count + 1) * UNIT[dtype] * mag
    err = np.abs(grad.double().numpy() - exact)
    assert (err <= bound).all(), (err - bound).max()
    assert count[-1, 0] == 0 and not grad[-1].any()  # the unused id

    leaf = table.clone().requires_grad_(True)
    leaf[ids.long()].backward(g)
    diff = np.abs(grad.double().numpy() - leaf.grad.double().numpy())
    assert (diff <= 2 * bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_take_rows_gradient_is_jax_scatter_add(dtype):
    """The JAX package's take backward (a scatter-add in the cotangent's
    dtype, one row after the other) on the same rows: the same bits. A
    1-D table too (ev_sq's per-entity squares)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for width in (24, None):
        table, ids, g = draw(5000, 50, width or 1, dtype, seed=1)
        if width is None:
            table, g = table[:, 0].contiguous(), g[:, 0].contiguous()
        _, grad = take_rows_grad(table, ids, g)
        jt = jnp.asarray(table.float().numpy()).astype(jdt)
        jg = jnp.asarray(g.float().numpy()).astype(jdt)
        want = jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids.numpy()),
                                          axis=0), jt)[1](jg)[0]
        np.testing.assert_array_equal(
            grad.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_take_rows_gradient_is_one_sum_at_scale(dtype):
    """200,000 rows onto 237 ids (the size at which autograd's index_put_
    gave 5 sums in 5 calls), at the default thread count."""
    table, ids, g = draw(200_000, 237, 20, dtype, seed=2)
    sums = {take_rows_grad(table, ids, g)[1].float().numpy().tobytes()
            for _ in range(5)}
    assert len(sums) == 1


def test_take_rows_without_table_gradient():
    table, ids, g = draw(100, 10, 4, torch.float32)
    out = gather.take_rows(table, ids)
    assert not out.requires_grad and torch.equal(out, table[ids])


def test_id_csr_is_the_stable_sort_by_id():
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 30, (7, 50)))
    ids[ids == 11] = 12  # an id with no rows
    row_ptr, order = gather.id_csr(ids, 33)
    flat = ids.reshape(-1)
    assert row_ptr.dtype == torch.int32 and row_ptr.shape == (34,)
    counts = torch.bincount(flat, minlength=33)
    assert row_ptr[0] == 0 and counts[11] == 0 and counts[30:].sum() == 0
    assert torch.equal(row_ptr.long().diff(), counts)
    assert torch.equal(order, torch.from_numpy(
        np.argsort(flat.numpy(), kind="stable")))


@pytest.mark.parametrize("width", [1, 5, 2500])
def test_sum_by_csr_equals_index_add(width):
    """The card's sum by id (sort, CSR, kernel 3 over it) through kernel
    3's plain version, against index_add_ (what add_by_id runs on the CPU)
    and a float64 sum; ids with no rows give zero rows. Widths: the fused
    backward's per-id scalars, d C's B = 5, d blocks' B*dr*dr = 2,500."""
    rng = np.random.default_rng(4)
    n, n_ids = 3000, 237
    ids = torch.from_numpy(rng.integers(0, n_ids - 40, n))
    values = torch.from_numpy(rng.standard_normal((n, width))
                              .astype(np.float32))
    got = gather.sum_by_csr(values, *gather.id_csr(ids, n_ids), n_ids)
    want = torch.zeros(n_ids, width).index_add_(0, ids, values)
    exact, mag, count = per_id_sum(ids, values, n_ids)
    bound = (count + 1) * UNIT[torch.float32] * mag
    assert got.shape == (n_ids, width)
    assert (np.abs(got.double().numpy() - exact) <= bound).all()
    assert (np.abs(got.double().numpy() - want.double().numpy())
            <= 2 * bound).all()
    assert not got[n_ids - 40:].any()
    assert torch.equal(gather.add_by_id(torch.ones(n_ids, width), ids,
                                        values),
                       torch.ones(n_ids, width).index_add_(0, ids, values))


def test_sum_by_csr_counts_only_card_launches(monkeypatch):
    """On the CPU the plain version runs and no launch is counted; the
    layout kernel 3 gets is unweighted, with perm the sort order."""
    seen = {}

    def fake_aggregate(msgs, layout, n, perm, *, weighted, counter):
        seen.update(layout=layout, perm=perm, weighted=weighted,
                    counter=counter)
        return staircase.staircase_aggregate_reference(msgs, layout, n,
                                                       perm, weighted)
    before = gather.sum_by_csr.launches
    monkeypatch.setattr(staircase, "aggregate", fake_aggregate)
    ids = torch.tensor([2, 0, 2, 1])
    values = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = gather.sum_by_csr(values, *gather.id_csr(ids, 3), 3)
    assert out.tolist() == [[2, 3], [6, 7], [4, 6]]
    assert isinstance(seen["layout"], CsrLayout)
    assert seen["perm"].tolist() == [1, 3, 0, 2]
    assert seen["weighted"] is False and seen["counter"] is gather.sum_by_csr
    assert gather.sum_by_csr.launches == before
