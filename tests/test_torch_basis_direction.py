"""The port's basis_direction (project, combine; twin pass for d features,
torch ops for d W_flat and d C) on the CPU plain path, against the JAX
package's staircase2.basis_direction run in Pallas interpret mode and
jax.grad of it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationprediction_tpu import graph as jax_graph
from relationprediction_tpu.ops import staircase2 as jax_s2
from relationprediction_torch import graph as torch_graph
from relationprediction_torch.ops import staircase2 as torch_s2

from test_torch_block_direction_grad import R, V, skewed_triples

N_BASES, D_IN, D_OUT = 3, 12, 16
TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_staircase2.py:191-192
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)   # tests/test_staircase2.py:196-198


def dense_inputs(seed):
    rng = np.random.default_rng(seed + 200)
    x = rng.standard_normal((V, D_IN)).astype(np.float32)
    w_flat = rng.standard_normal((D_IN, N_BASES * D_OUT)).astype(np.float32)
    coef = rng.standard_normal((R, N_BASES)).astype(np.float32)
    probe = rng.standard_normal((V, D_OUT)).astype(np.float32)
    return x, w_flat, coef, probe


def graphs(seed):
    triples = skewed_triples(seed)
    jg = jax_graph.build_graph_batch(triples, V, R, pad_to=512,
                                     staircase2=True, s2_rb=64,
                                     s2_chunk=128)
    return triples, jg, torch_graph.build_graph_batch(triples, V, R)


def layouts(jg, tg, direction):
    if direction == "forward":
        return jg.sc2_fwd, tg.fwd, tg.fwd_twin, tg.bwd
    return jg.sc2_bwd, tg.bwd, tg.bwd_twin, tg.fwd


def jax_grads(x, w_flat, coef, probe, pair):
    def loss(f, w, c):
        out = jax_s2.basis_direction(f, w, c, pair, N_BASES, V, True, None)
        return jnp.sum(out * jnp.asarray(probe))
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w_flat), jnp.asarray(coef))
    return [np.asarray(g) for g in grads]


def torch_grads(x, w_flat, coef, probe, layout, twin):
    f, w, c = (torch.from_numpy(a).requires_grad_(True)
               for a in (x, w_flat, coef))
    out = torch_s2.basis_direction(f, w, c, layout, V, twin)
    (out * torch.from_numpy(probe)).sum().backward()
    return [t.grad.numpy() for t in (f, w, c)]


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_forward_matches_jax(direction):
    """A skewed-degree graph with a repeated edge and an isolated
    vertex."""
    triples, jg, tg = graphs(0)
    assert not np.isin(V - 1, triples[:, [0, 2]])
    x, w_flat, coef, _ = dense_inputs(0)
    pair, layout, _, _ = layouts(jg, tg, direction)
    want = jax_s2.basis_direction(jnp.asarray(x), jnp.asarray(w_flat),
                                  jnp.asarray(coef), pair, N_BASES, V, True,
                                  None)
    got = torch_s2.basis_direction(torch.from_numpy(x),
                                   torch.from_numpy(w_flat),
                                   torch.from_numpy(coef), layout, V)
    assert got.shape == (V, D_OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[V - 1].any()
    # the plain version composed by hand gives the same
    ref = torch_s2.basis_direction_reference(
        torch.from_numpy(x), torch.from_numpy(w_flat),
        torch.from_numpy(coef), layout, V)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_gradient_matches_jax_and_the_wrong_twin_differs(direction):
    """d features, d W_flat and d C against jax.grad; the twin's weights
    are the direction's own degree norms, so the opposite CSR (same edges,
    other weights) as twin gives another d features."""
    triples, jg, tg = graphs(1)
    in_deg = np.bincount(triples[:, 2], minlength=V)
    out_deg = np.bincount(triples[:, 0], minlength=V)
    assert (in_deg != out_deg).mean() > 0.5
    x, w_flat, coef, probe = dense_inputs(1)
    pair, layout, twin, wrong = layouts(jg, tg, direction)
    want = jax_grads(x, w_flat, coef, probe, pair)
    got = torch_grads(x, w_flat, coef, probe, layout, twin)
    for name, g, w in zip(("features", "W_flat", "C"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
    assert not got[0][V - 1].any()  # the isolated vertex gets no gradient
    gf_wrong = torch_grads(x, w_flat, coef, probe, layout, wrong)[0]
    assert not np.allclose(gf_wrong, want[0], **GRAD_TOL)


def test_one_edge_pins_the_twin_weights_orientation():
    """On one edge 0 -> 1 of weight 0.5, relation 0, two bases:
    out[1] = 0.5 sum_b C[0, b] x[0] @ W_b;
    d x[0] = 0.5 sum_b C[0, b] W_b @ g[1];
    d W_b = 0.5 C[0, b] x[0] (outer) g[1];
    d C[0, b] = 0.5 <x[0] @ W_b, g[1]>.
    A transposed or basis-minor w_t fails the d x line."""
    rng = np.random.default_rng(4)
    n_bases, d_in, d_out = 2, 3, 4
    x = rng.standard_normal((2, d_in)).astype(np.float32)
    w = rng.standard_normal((d_in, n_bases, d_out)).astype(np.float32)
    c = rng.standard_normal((1, n_bases)).astype(np.float32)
    g = rng.standard_normal((2, d_out)).astype(np.float32)
    layout, _ = torch_graph.build_csr([0], [0], [1], [0.5], 2)
    twin, _ = torch_graph.build_csr([1], [0], [0], [0.5], 2)
    xt, wt, ct = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w.reshape(d_in, -1), c))
    out = torch_s2.basis_direction(xt, wt, ct, layout, 2, twin)
    np.testing.assert_allclose(
        out.detach().numpy()[1],
        0.5 * np.einsum("b,i,ibo->o", c[0], x[0], w), rtol=1e-6, atol=1e-6)
    assert not out[0].any()
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(
        xt.grad[0].numpy(), 0.5 * np.einsum("b,ibo,o->i", c[0], w, g[1]),
        rtol=1e-6, atol=1e-6)
    assert not xt.grad[1].any()
    np.testing.assert_allclose(
        wt.grad.numpy().reshape(d_in, n_bases, d_out),
        0.5 * np.einsum("b,i,o->ibo", c[0], x[0], g[1]), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        ct.grad.numpy()[0], 0.5 * np.einsum("i,ibo,o->b", x[0], w, g[1]),
        rtol=1e-6, atol=1e-6)
    # w_t is basis-major, then input feature: w_t[o, b*d_in + i] = W[i, b, o]
    w_t = torch_s2.basis_twin_weights(torch.from_numpy(w.reshape(d_in, -1)),
                                      n_bases).numpy()
    assert w_t.shape == (d_out, n_bases * d_in)
    np.testing.assert_array_equal(w_t.reshape(d_out, n_bases, d_in),
                                  w.transpose(2, 1, 0))


def test_dweights_chunks_and_flags():
    """basis_direction_dweights gives the same sums in small chunks and
    computes only what it is asked for."""
    _, _, tg = graphs(2)
    x, w_flat, coef, probe = (torch.from_numpy(a) for a in dense_inputs(2))
    proj = torch_s2.basis_project_reference(x, w_flat)
    whole = torch_s2.basis_direction_dweights(x, proj, probe, coef, tg.fwd)
    chunked = torch_s2.basis_direction_dweights(x, proj, probe, coef, tg.fwd,
                                                edge_chunk=37)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dw, dc = torch_s2.basis_direction_dweights(x, proj, probe, coef, tg.fwd,
                                               need_w=False)
    assert dw is None and dc is not None
    dw, dc = torch_s2.basis_direction_dweights(x, proj, probe, coef, tg.fwd,
                                               need_c=False)
    assert dw is not None and dc is None


def test_cpu_path_launches_nothing_and_needs_the_twin():
    _, _, tg = graphs(3)
    x, w_flat, coef, probe = dense_inputs(3)
    counts = ("launches", "twin_launches", "project_launches")
    before = [getattr(torch_s2.basis_direction, k) for k in counts]
    launch_counts = torch_s2.launch_counts()
    torch_grads(x, w_flat, coef, probe, tg.fwd, tg.fwd_twin)
    assert [getattr(torch_s2.basis_direction, k) for k in counts] == before
    assert torch_s2.launch_counts() == launch_counts
    with pytest.raises(ValueError, match="twin"):
        torch_grads(x, w_flat, coef, probe, tg.fwd, None)
    # d W_flat and d C alone need no twin
    w = torch.from_numpy(w_flat).requires_grad_(True)
    c = torch.from_numpy(coef).requires_grad_(True)
    torch_s2.basis_direction(torch.from_numpy(x), w, c, tg.fwd, V).sum() \
        .backward()
    assert w.grad is not None and c.grad is not None


def test_unsupported_device_raises():
    _, _, tg = graphs(0)
    x, w_flat, coef, _ = (torch.from_numpy(a) for a in dense_inputs(0))
    with pytest.raises(ValueError, match="unsupported device"):
        torch_s2.basis_direction(x.to("meta"), w_flat.to("meta"),
                                 coef.to("meta"), tg.fwd, V)


# ---------------------------------------------------------------------------
# The 3xTF32 split of basis_project (csrc/basis_project.cu)
# ---------------------------------------------------------------------------

def f32_bits(a):
    return torch.as_tensor(np.asarray(a, np.float32)).view(torch.int32)


@pytest.mark.parametrize("case", ["wide_range", "ties", "specials",
                                  "three_parts"])
def test_tf32_split_rounds_to_nearest_away_and_rebuilds(case):
    rng = np.random.default_rng(7)
    if case == "three_parts":
        x = (rng.standard_normal(20000)
             * 10.0 ** rng.uniform(-25, 25, 20000)).astype(np.float32)
        parts = torch_s2.tf32_split_reference(torch.from_numpy(x), 3)
        for part in parts:
            assert not (part.view(torch.int32) & 0x1FFF).any()
        # three parts hold every bit of a normal float
        rebuilt = sum(part.double() for part in parts)
        np.testing.assert_array_equal(rebuilt.numpy(), x.astype(np.float64))
        assert torch.equal(parts[0], torch_s2.tf32_split_reference(
            torch.from_numpy(x))[0])
        return
    if case == "wide_range":
        x = (rng.standard_normal(20000)
             * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
        x[:3] = [0.0, -0.0, 1e-40]  # zeros and a subnormal
    elif case == "ties":
        # low 13 bits exactly half of TF32's last place: away from zero
        base = (rng.integers(0x00800000, 0x7F000000, 1000) & ~0x1FFF) \
            .astype(np.int64)
        bits = np.concatenate([base | 0x1000, base | 0x0FFF, base | 0x1001])
        x = bits.astype(np.uint32).view(np.float32)
        x = np.concatenate([x, -x])
    else:
        top = np.finfo(np.float32).max
        x = np.array([np.inf, -np.inf, np.nan, top, -top], np.float32)
    t = torch.from_numpy(x)
    big, small = torch_s2.tf32_split_reference(t)
    for half in (big, small):
        finite = torch.isfinite(half)
        assert not (half.view(torch.int32)[finite] & 0x1FFF).any()
    if case == "ties":
        n = 1000
        b = big.view(torch.int32).numpy() & 0x7FFFFFFF
        m = np.concatenate([base, base, base]).astype(np.int64)
        np.testing.assert_array_equal(b[:n], m[:n] + 0x2000)      # tie: up
        np.testing.assert_array_equal(b[n:2 * n], m[:n])          # below
        np.testing.assert_array_equal(b[2 * n:3 * n], m[:n] + 0x2000)
        np.testing.assert_array_equal(b[3 * n:], b[:3 * n])       # sign
    if case == "specials":
        got = big.numpy()
        assert got[0] == np.inf and got[1] == -np.inf and np.isnan(got[2])
        # the largest finite floats round past TF32's largest to inf
        assert got[3] == np.inf and got[4] == -np.inf
        return
    rebuilt = big.double() + small.double()
    err = (rebuilt - t.double()).abs()
    # where the remainder x - big is a normal float (|x| >= 2^-100), so
    # that small keeps its 11 bits
    normal = t.abs() >= 2.0 ** -100
    assert (err <= 2.0 ** -22 * t.double().abs())[normal].all()
    # a rounding by truncation would leave the whole remainder to small
    assert (f32_bits(small).numpy() != 0).any()


def test_3xtf32_meets_the_f32_allowance_and_1xtf32_does_not():
    """The precision the card's basis_project is held to
    (chip_smoke.project_exact's allowance) at 512 x 500 x 512: three TF32
    products of the halves, summed in f32, meet it; one product of the
    rounded operands, what TF32 matmul gives, does not."""
    import chip_smoke
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((512, 500)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((500, 512)).astype(np.float32))
    exact, allowance = chip_smoke.project_exact(x, w)
    (xb, xs), (wb, ws) = (torch_s2.tf32_split_reference(a) for a in (x, w))
    three = xs @ wb + xb @ ws + xb @ wb
    one = xb @ wb
    assert chip_smoke.over_allowance(three, exact, allowance) <= 0.5
    assert chip_smoke.over_allowance(one, exact, allowance) > 10
    assert chip_smoke.over_allowance(x @ w, exact, allowance) <= 0.5


def truncate_to_f32(a):
    """float64 -> float32 rounding toward zero."""
    f = a.astype(np.float32)
    past = np.abs(f.astype(np.float64)) > np.abs(a)
    f[past] = np.nextafter(f[past], np.float32(0))
    return f


def tensor_core_model(x, w, scheme, parts):
    """The kernel's arithmetic with the tensor cores modelled as exact
    products summed, then truncated to f32, at every k-step of 8 (the
    rounding of their accumulator). "kernel": the products of a k-tile of
    32 into an accumulator that starts afresh every k-tile and is added
    into an f32 sum (round to nearest) after it, except that with 3 parts
    the correction products run into one accumulator over K, added last;
    "one_accumulator": all products into one accumulator."""
    m, k = x.shape
    kp = -(-k // 32) * 32
    pad = [np.zeros((m, kp), np.float32), np.zeros((kp, w.shape[1]),
                                                   np.float32)]
    pad[0][:, :k], pad[1][:k] = x, w
    xp, wp = (tuple(t.numpy().astype(np.float64)
                    for t in torch_s2.tf32_split_reference(
                        torch.from_numpy(a), parts)) for a in pad)
    corr = ([(1, 0), (0, 1)] if parts == 2
            else [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1)])
    total = np.zeros((m, w.shape[1]), np.float32)
    acc = np.zeros_like(total)
    for k0 in range(0, kp, 32):
        lead = np.zeros_like(total)
        for s in range(k0, k0 + 32, 8):
            for i, j in corr:
                step = xp[i][:, s:s + 8] @ wp[j][s:s + 8]
                if scheme == "kernel" and parts == 2:
                    lead = truncate_to_f32(lead + step)
                else:
                    acc = truncate_to_f32(acc + step)
            step = xp[0][:, s:s + 8] @ wp[0][s:s + 8]
            if scheme == "kernel":
                lead = truncate_to_f32(lead + step)
            else:
                acc = truncate_to_f32(acc + step)
        total = total + lead
    return torch.from_numpy(total + acc)


@pytest.mark.parametrize("scheme,parts,shape,within", [
    ("kernel", 2, (512, 500, 512), True),
    ("kernel", 3, (129, 33, 65), True),
    ("kernel", 3, (1, 1, 7), True),
    ("one_accumulator", 2, (512, 500, 512), False),
    ("kernel", 2, (1, 1, 7), False)])
def test_split_tf32_under_truncating_accumulation(scheme, parts, shape,
                                                   within):
    """Why basis_project.cu sums as it does: with the tensor cores'
    accumulator truncating, three products into one accumulator over K =
    500 miss the allowance, the kernel's promotion of the leading product
    every k-tile meets it; and at K = 1 two parts (22 bits) miss it where
    three (exact) meet it, so a short K takes three parts."""
    import chip_smoke
    m, k, n = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    exact, allowance = chip_smoke.project_exact(torch.from_numpy(x),
                                                torch.from_numpy(w))
    over = chip_smoke.over_allowance(tensor_core_model(x, w, scheme, parts),
                                     exact, allowance)
    assert (over <= 0.8) if within else (over > 1.1)


@pytest.mark.parametrize("n_src,n_rows", [(90, 30), (30, 90)],
                         ids=["fewer_rows", "more_rows"])
def test_rectangular_layout_forward_and_gradient(n_src, n_rows):
    """A layout whose rows differ from the features' (a vertex shard's):
    the output and d features (the twin pass into the features' rows), d
    W_flat and d C against autograd of the plain version in float64."""
    from test_torch_block_direction_grad import rectangular
    layout, twin = rectangular(n_src, n_rows, 21)
    rng = np.random.default_rng(22)
    arrays = (rng.standard_normal((n_src, D_IN)),
              rng.standard_normal((D_IN, N_BASES * D_OUT)),
              rng.standard_normal((R, N_BASES)))
    probe = torch.from_numpy(rng.standard_normal((n_rows, D_OUT)))
    f32 = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
           for a in arrays]
    out = torch_s2.basis_direction(*f32, layout, n_rows, twin)
    (out * probe.float()).sum().backward()
    f64 = [torch.tensor(a, requires_grad=True) for a in arrays]
    want = torch_s2.basis_direction_reference(*f64, layout, n_rows)
    (want * probe).sum().backward()
    assert out.shape == (n_rows, D_OUT) and f32[0].grad.shape == (n_src,
                                                                  D_IN)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for got, ref in zip(f32, f64):
        np.testing.assert_allclose(got.grad.numpy(), ref.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_combine_check_holds_proj_to_the_layouts_sources(monkeypatch):
    """basis_combine's host check takes a rectangular layout and holds
    proj's rows to its sources, the output's to its rows."""
    import types

    from test_torch_block_direction_grad import rectangular
    monkeypatch.setattr(torch_s2, "basis_kernel_library", lambda: (
        types.SimpleNamespace(basis_direction_max_bases=lambda: 16), None))
    layout, twin = rectangular(90, 30, 23)
    coef = torch.zeros(R, N_BASES)
    torch_s2._check_combine(torch.zeros(90, N_BASES * D_OUT), coef, layout,
                            30)
    torch_s2._check_combine(torch.zeros(30, N_BASES * D_OUT), coef, twin,
                            90)
    with pytest.raises(ValueError, match="gathers from 90"):
        torch_s2._check_combine(torch.zeros(30, N_BASES * D_OUT), coef,
                                layout, 30)
    with pytest.raises(ValueError, match="expected 90"):
        torch_s2._check_combine(torch.zeros(90, N_BASES * D_OUT), coef,
                                layout, 90)
