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
