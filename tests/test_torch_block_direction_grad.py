"""The port's block_direction gradient (twin pass for d features, torch ops
for d blocks) on the CPU plain path, against jax.grad of the JAX package's
staircase2.block_direction run in Pallas interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationprediction_tpu import graph as jax_graph
from relationprediction_tpu.ops import staircase2 as jax_s2
from relationprediction_torch import graph as torch_graph
from relationprediction_torch.ops import staircase2 as torch_s2

V, R, E = 120, 6, 500
N_BLOCKS, DR = 4, 5
D = N_BLOCKS * DR


def skewed_triples(seed):
    """Hub senders (Zipf) against uniform receivers, so in- and out-degrees
    differ; a repeated (s, r, o); vertex V - 1 has no edge."""
    rng = np.random.default_rng(seed)
    s = (rng.zipf(1.5, E) - 1) % (V - 1)
    o = rng.integers(0, V - 1, E)
    r = rng.integers(0, R, E)
    s[1], r[1], o[1] = s[0], r[0], o[0]
    return np.stack([s, r, o], axis=1).astype(np.int32)


def dense_inputs(seed):
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((V, D)).astype(np.float32)
    blocks = rng.standard_normal((R, N_BLOCKS, DR, DR)).astype(np.float32)
    probe = rng.standard_normal((V, D)).astype(np.float32)
    return x, blocks, probe


def jax_grads(x, blocks, probe, pair):
    def loss(f, w):
        out = jax_s2.block_direction(f, w, pair, N_BLOCKS, V, True, None)
        return jnp.sum(out * jnp.asarray(probe))
    gf, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                            jnp.asarray(blocks))
    return np.asarray(gf), np.asarray(gw)


def torch_grads(x, blocks, probe, layout, twin):
    f = torch.from_numpy(x).requires_grad_(True)
    w = torch.from_numpy(blocks).requires_grad_(True)
    out = torch_s2.block_direction(f, w, layout, V, twin)
    (out * torch.from_numpy(probe)).sum().backward()
    return f.grad.numpy(), w.grad.numpy()


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_graph_twins_give_jax_gradient(direction):
    """Through build_graph_batch's twins, whose weights are the
    direction's own degree norms: reusing the opposite CSR's weights
    would fail here, since in- and out-degrees differ."""
    triples = skewed_triples(0)
    x, blocks, probe = dense_inputs(0)
    jg = jax_graph.build_graph_batch(triples, V, R, pad_to=512,
                                     staircase2=True, s2_rb=64,
                                     s2_chunk=128)
    tg = torch_graph.build_graph_batch(triples, V, R)
    in_deg = np.bincount(triples[:, 2], minlength=V)
    out_deg = np.bincount(triples[:, 0], minlength=V)
    assert (in_deg != out_deg).mean() > 0.5
    pair = jg.sc2_fwd if direction == "forward" else jg.sc2_bwd
    layout, twin = ((tg.fwd, tg.fwd_twin) if direction == "forward"
                    else (tg.bwd, tg.bwd_twin))
    assert_grads_close(torch_grads(x, blocks, probe, layout, twin),
                       jax_grads(x, blocks, probe, pair))
    # the wrong twin (the opposite CSR with its own weights) differs
    wrong = tg.bwd if direction == "forward" else tg.fwd
    gf_wrong, _ = torch_grads(x, blocks, probe, layout, wrong)
    assert not np.allclose(gf_wrong, jax_grads(x, blocks, probe, pair)[0],
                           rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_padded_edge_list_gives_jax_gradient(direction):
    """Any weights, with padding edges (weight 0, a phantom target), a
    repeated edge and an isolated vertex; the twin CSR is built from the
    forward CSR's real edges through build_csr's edge order."""
    triples = skewed_triples(1)
    senders, relations, receivers = (triples[:, 0].copy(), triples[:, 1],
                                     triples[:, 2].copy())
    rng = np.random.default_rng(7)
    weights = (rng.random(E) * 0.9 + 0.1).astype(np.float32)
    weights[rng.random(E) < 0.1] = 0.0
    weights[:2] = 0.5
    senders[-5:], receivers[-5:] = V, V
    weights[-5:] = 0.0
    if direction == "forward":
        receivers[-8:-5] = V      # a real sender with a phantom target
    else:
        senders[-8:-5] = V
    x, blocks, probe = dense_inputs(1)
    pair = jax_s2.build_staircase2_pair(
        senders, relations, receivers, weights, V, direction=direction,
        rb=64, chunk=128, k=2, group=8)
    src, tgt = ((senders, receivers) if direction == "forward"
                else (receivers, senders))
    layout, order = torch_graph.build_csr(src, relations, tgt, weights, V)
    twin, _ = torch_graph.build_csr(tgt[order], relations[order],
                                    src[order], weights[order], V)
    got = torch_grads(x, blocks, probe, layout, twin)
    assert_grads_close(got, jax_grads(x, blocks, probe, pair))
    assert not got[0][V - 1].any()  # the isolated vertex gets no gradient


def test_twin_pass_reads_blocks_transposed():
    """On one edge 0 -> 1 of weight 0.5: d x[0] = 0.5 W^T g[1] per block,
    d W = 0.5 g[1] x[0]^T per block."""
    rng = np.random.default_rng(3)
    n_blocks, dr = 3, 2
    x = torch.from_numpy(
        rng.standard_normal((2, n_blocks * dr)).astype(np.float32))
    w = torch.from_numpy(
        rng.standard_normal((1, n_blocks, dr, dr)).astype(np.float32))
    g = rng.standard_normal((2, n_blocks * dr)).astype(np.float32)
    layout, _ = torch_graph.build_csr([0], [0], [1], [0.5], 2)
    twin, _ = torch_graph.build_csr([1], [0], [0], [0.5], 2)
    x.requires_grad_(True)
    w.requires_grad_(True)
    out = torch_s2.block_direction(x, w, layout, 2, twin)
    (out * torch.from_numpy(g)).sum().backward()
    wb, gb = w.detach().numpy()[0], g[1].reshape(n_blocks, dr)
    xb = x.detach().numpy()[0].reshape(n_blocks, dr)
    np.testing.assert_allclose(
        x.grad[0].numpy(),
        0.5 * np.einsum("bij,bi->bj", wb, gb).reshape(-1), rtol=1e-6,
        atol=1e-6)
    assert not x.grad[1].any()
    np.testing.assert_allclose(w.grad[0].numpy(),
                               0.5 * np.einsum("bi,bj->bij", gb, xb),
                               rtol=1e-6, atol=1e-6)


def test_twins_share_the_opposite_layouts_index_arrays():
    tg = torch_graph.build_graph_batch(skewed_triples(2), V, R)
    for g in (tg, tg.to("cpu")):
        for twin, other in ((g.fwd_twin, g.bwd), (g.bwd_twin, g.fwd)):
            assert twin.row_ptr is other.row_ptr
            assert twin.src is other.src and twin.rel is other.rel
            assert twin.w is not other.w
    assert not torch.equal(tg.fwd_twin.w, tg.bwd.w)


def test_cpu_backward_launches_nothing_and_needs_the_twin():
    triples = skewed_triples(3)
    tg = torch_graph.build_graph_batch(triples, V, R)
    x, blocks, probe = dense_inputs(3)
    before = (torch_s2.block_direction.launches,
              torch_s2.block_direction.twin_launches)
    torch_grads(x, blocks, probe, tg.fwd, tg.fwd_twin)
    assert (torch_s2.block_direction.launches,
            torch_s2.block_direction.twin_launches) == before
    with pytest.raises(ValueError, match="twin"):
        torch_grads(x, blocks, probe, tg.fwd, None)
    # d blocks alone needs no twin
    w = torch.from_numpy(blocks).requires_grad_(True)
    torch_s2.block_direction(torch.from_numpy(x), w, tg.fwd, V).sum() \
        .backward()
    assert w.grad is not None


def rectangular(n_src, n_rows, seed, e=300):
    """A layout of ``n_rows`` rows reading a table of ``n_src`` rows (a
    vertex shard's: its owned rows from a longer halo buffer, or the
    reverse), its twin, and some padding edges of weight 0."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    tgt = rng.integers(0, n_rows, e)
    rel = rng.integers(0, R, e)
    w = (rng.random(e) * 0.9 + 0.1).astype(np.float32)
    w[:5] = 0.0
    layout, order = torch_graph.build_csr(src, rel, tgt, w, n_rows,
                                          n_sources=n_src)
    twin, _ = torch_graph.build_csr(tgt[order], rel[order], src[order],
                                    w[order], n_src, n_sources=n_rows)
    return layout, twin


@pytest.mark.parametrize("n_src,n_rows", [(90, 30), (30, 90)],
                         ids=["fewer_rows", "more_rows"])
def test_rectangular_layout_forward_and_gradient(n_src, n_rows):
    """A layout whose rows differ from the features' (n_rows !=
    features.shape[0]): the output, d features (the twin pass, whose rows
    are the features') and d blocks against autograd of the plain version
    in float64."""
    layout, twin = rectangular(n_src, n_rows, 11)
    assert (layout.n_rows, layout.source_rows) == (n_rows, n_src)
    assert (twin.n_rows, twin.source_rows) == (n_src, n_rows)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((n_src, D)).astype(np.float32)
    blocks = rng.standard_normal((R, N_BLOCKS, DR, DR)).astype(np.float32)
    probe = torch.from_numpy(rng.standard_normal((n_rows, D)))
    f = torch.from_numpy(x).requires_grad_(True)
    w = torch.from_numpy(blocks).requires_grad_(True)
    out = torch_s2.block_direction(f, w, layout, n_rows, twin)
    (out * probe.float()).sum().backward()
    f64 = torch.from_numpy(x).double().requires_grad_(True)
    w64 = torch.from_numpy(blocks).double().requires_grad_(True)
    want = torch_s2.block_direction_reference(f64, w64, layout, n_rows)
    (want * probe).sum().backward()
    assert out.shape == (n_rows, D) and f.grad.shape == (n_src, D)
    for got, ref in ((out, want), (f.grad, f64.grad), (w.grad, w64.grad)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   ref.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_kernel_checks_rows_and_sources_apart(monkeypatch):
    """The kernel's host check takes a rectangular layout, and holds the
    features' rows to the layout's sources and the output's to its rows:
    the kernels check no index on the device."""
    import types
    monkeypatch.setattr(torch_s2, "kernel_library", lambda: (
        types.SimpleNamespace(block_direction_max_blocks=lambda: 1024),
        None))
    layout, twin = rectangular(90, 30, 13)
    blocks = torch.zeros(R, N_BLOCKS, DR, DR)
    torch_s2._check(torch.zeros(90, D), blocks, layout, 30)
    torch_s2._check(torch.zeros(30, D), blocks, twin, 90)
    with pytest.raises(ValueError, match="gathers from 90"):
        torch_s2._check(torch.zeros(30, D), blocks, layout, 30)
    with pytest.raises(ValueError, match="expected 90"):
        torch_s2._check(torch.zeros(90, D), blocks, layout, 90)
