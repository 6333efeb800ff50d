"""bf16 message precision, op by op, the port's plain path on the CPU
against the JAX package's ops with ``compute_dtype=jnp.bfloat16`` (Pallas
in interpret mode): block_direction, basis_direction, staircase_aggregate
and scatter2, forward and every gradient; then the factored energies'
bf16 ``_fused`` / ``_single_fused`` backward and their dispatch rule.

The two round at different places (JAX rounds the weighted rows, the
per-edge products and the basis sum to bf16; the port rounds only the
kernels' inputs and sums in f32), so neither is held to the other's bits.
Each is held to a float64 oracle of the same f32 inputs, in relative L2
norm: the port's error at most 1.5 x JAX's own + 1e-6, and the port
within 1e-2 of JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationprediction_tpu import graph as jax_graph
from relationprediction_tpu.ops import neg_energy as jax_ne
from relationprediction_tpu.ops import staircase as jax_sc
from relationprediction_tpu.ops import staircase2 as jax_s2
from relationprediction_torch import graph as torch_graph
from relationprediction_torch.ops import neg_energy, staircase, staircase2

V, R, E = 120, 6, 500
N_BLOCKS, DR = 4, 5
D = N_BLOCKS * DR
N_BASES, D_IN, D_OUT = 3, 16, 12
BF16 = torch.bfloat16


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_bar(port, jax_out, exact, what):
    """The port's error against the float64 oracle at most 1.5 x JAX's +
    1e-6, and the port within 1e-2 of JAX (relative L2)."""
    port, jax_out = np.asarray(port, np.float64), np.asarray(jax_out,
                                                             np.float64)
    port_err, jax_err = rel_l2(port, exact), rel_l2(jax_out, exact)
    assert np.isfinite(port).all(), what
    assert port_err <= 1.5 * jax_err + 1e-6, (what, port_err, jax_err)
    assert rel_l2(port, jax_out) <= 1e-2, (what, rel_l2(port, jax_out))


def skewed_triples(seed):
    """Zipf senders against uniform receivers; a repeated edge."""
    rng = np.random.default_rng(seed)
    s = (rng.zipf(1.5, E) - 1) % (V - 1)
    o = rng.integers(0, V - 1, E)
    r = rng.integers(0, R, E)
    s[1], r[1], o[1] = s[0], r[0], o[0]
    return np.stack([s, r, o], axis=1).astype(np.int32)


def graphs(seed):
    triples = skewed_triples(seed)
    jg = jax_graph.build_graph_batch(triples, V, R, pad_to=512,
                                     staircase2=True, s2_rb=64,
                                     s2_chunk=128)
    return jg, torch_graph.build_graph_batch(triples, V, R)


def directions(jg, tg, direction):
    if direction == "forward":
        return jg.sc2_fwd, tg.fwd, tg.fwd_twin
    return jg.sc2_bwd, tg.bwd, tg.bwd_twin


def port_grads(op, arrays, probe, dtype=None):
    """The port op's output and gradients for inputs ``arrays`` (numpy)
    and the cotangent ``probe``; float64 inputs give the oracle."""
    leaves = [torch.from_numpy(a).to(dtype or torch.float32)
              .requires_grad_(True) for a in arrays]
    out = op(*leaves)
    (out * torch.from_numpy(probe).to(out.dtype)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def jax_grads(op, arrays, probe):
    def loss(*xs):
        out = op(*xs)
        return jnp.sum(out * jnp.asarray(probe)), out
    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(arrays))), has_aux=True)(
            *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_block_direction_bf16_matches_jax(direction):
    """Forward, d features (the twin pass on bf16 g and blocks) and d
    blocks (f32, from the saved f32 inputs)."""
    jg, tg = graphs(0)
    pair, layout, twin = directions(jg, tg, direction)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((V, D)).astype(np.float32)
    blocks = rng.standard_normal((R, N_BLOCKS, DR, DR)).astype(np.float32)
    probe = rng.standard_normal((V, D)).astype(np.float32)
    want, want_g = jax_grads(
        lambda f, w: jax_s2.block_direction(f, w, pair, N_BLOCKS, V, True,
                                            jnp.bfloat16), (x, blocks),
        probe)
    got, got_g = port_grads(
        lambda f, w: staircase2.block_direction(f, w, layout, V, twin, BF16),
        (x, blocks), probe)
    exact, exact_g = port_grads(
        lambda f, w: staircase2.block_direction_reference(f, w, layout, V),
        (x, blocks), probe, torch.float64)
    assert_bar(got, want, exact, "forward")
    for name, g, w, e in zip(("d features", "d blocks"), got_g, want_g,
                             exact_g):
        assert_bar(g, w, e, name)
    # bf16 inputs really round: the f32 op is closer to the oracle
    f32, _ = port_grads(
        lambda f, w: staircase2.block_direction(f, w, layout, V, twin),
        (x, blocks), probe)
    assert rel_l2(f32, exact) < 0.1 * rel_l2(got, exact)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_basis_direction_bf16_matches_jax(direction):
    """Forward (a bf16 P), d features (the twin pass on bf16 g and w_t),
    d W_flat and d C (f32, d C from an f32 P)."""
    jg, tg = graphs(2)
    pair, layout, twin = directions(jg, tg, direction)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((V, D_IN)).astype(np.float32)
    w_flat = rng.standard_normal((D_IN, N_BASES * D_OUT)).astype(np.float32)
    coef = rng.standard_normal((R, N_BASES)).astype(np.float32)
    probe = rng.standard_normal((V, D_OUT)).astype(np.float32)
    want, want_g = jax_grads(
        lambda f, w, c: jax_s2.basis_direction(f, w, c, pair, N_BASES, V,
                                               True, jnp.bfloat16),
        (x, w_flat, coef), probe)
    got, got_g = port_grads(
        lambda f, w, c: staircase2.basis_direction(f, w, c, layout, V, twin,
                                                   BF16),
        (x, w_flat, coef), probe)
    exact, exact_g = port_grads(
        lambda f, w, c: staircase2.basis_direction_reference(f, w, c,
                                                             layout, V),
        (x, w_flat, coef), probe, torch.float64)
    assert_bar(got, want, exact, "forward")
    for name, g, w, e in zip(("d features", "d W_flat", "d C"), got_g,
                             want_g, exact_g):
        assert_bar(g, w, e, name)
    # bf16 inputs really round: the f32 op is closer to the oracle
    f32, _ = port_grads(
        lambda f, w, c: staircase2.basis_direction(f, w, c, layout, V, twin),
        (x, w_flat, coef), probe)
    assert rel_l2(f32, exact) < 0.1 * rel_l2(got, exact)


def test_basis_project_bf16_plain_rounds_p():
    """The plain version of basis_project_bf16: bf16 inputs multiplied in
    f32, P rounded to nearest bf16 (within half a bf16 ulp of the f64
    product of the same bf16 values); f32 inputs keep the f32 product."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((33, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 27)).astype(np.float32))
    p = staircase2.basis_project_reference(x.to(BF16), w.to(BF16))
    assert p.dtype == BF16
    exact = x.to(BF16).double() @ w.to(BF16).double()
    assert ((p.double() - exact).abs() <= 2.0 ** -8 * exact.abs()
            + 1e-6).all()
    assert staircase2.basis_project_reference(x, w).dtype == torch.float32


def staircase_problem(seed):
    """Skewed targets with 10 % padding edges (weight 0 or the phantom
    target V), primary-order messages and a cotangent."""
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


def test_staircase_aggregate_bf16_matches_jax():
    """The segment sum and its VJP (an f32 row gather on both sides); the
    port's messages are JAX's in the CSR's entry order."""
    src, rel, tgt, w, msgs, probe = staircase_problem(5)
    jlayout = jax_sc.build_staircase_layout(tgt, w, V, rb=16, chunk=32)
    want, (want_g,) = jax_grads(
        lambda m: jax_sc.staircase_aggregate(m, jlayout, V, True,
                                             jnp.bfloat16), (msgs,), probe)
    layout, order = torch_graph.build_csr(src, rel, tgt, w, V)
    got, (got_g,) = port_grads(
        lambda m: staircase.staircase_aggregate(m, layout, V,
                                                compute_dtype=BF16),
        (msgs[order],), probe)
    exact, (exact_g,) = port_grads(
        lambda m: staircase.staircase_aggregate_reference(m, layout, V),
        (msgs[order],), probe, torch.float64)
    assert_bar(got, want, exact, "forward")
    assert_bar(got_g, want_g[order], exact_g, "d msgs")
    assert got.dtype == got_g.dtype == np.float32
    # bf16 messages really round: the f32 op is closer to the oracle
    f32 = staircase.staircase_aggregate(torch.from_numpy(msgs[order]),
                                        layout, V)
    assert rel_l2(f32, exact) < 0.1 * rel_l2(got, exact)


def test_scatter2_bf16_matches_jax():
    """scatter2 on primary-order messages with compute_dtype bf16 (the
    perm path of the bf16 kernel); its gradient the f32 gather VJP."""
    src, rel, tgt, w, msgs, probe = staircase_problem(6)
    jlayout = jax_s2.build_staircase2_layout(src, rel, tgt, w, V, rb=64,
                                             chunk=128, group=8)
    want = np.asarray(jax_s2.scatter2(jnp.asarray(msgs), jlayout, V,
                                      interpret=True,
                                      compute_dtype=jnp.bfloat16))
    layout, order = torch_graph.build_csr(src, rel, tgt, w, V)
    m = torch.from_numpy(msgs).requires_grad_(True)
    got = staircase2.scatter2(m, layout, V, order, compute_dtype=BF16)
    exact = staircase2.scatter2(torch.from_numpy(msgs).double(), layout, V,
                                order)
    assert_bar(got.detach().numpy(), want, exact.numpy(), "scatter2")
    # bf16 messages really round: the f32 op is closer to the oracle
    f32 = staircase2.scatter2(torch.from_numpy(msgs), layout, V, order)
    assert rel_l2(f32, exact) < 0.1 * rel_l2(got.detach(), exact)
    (got * torch.from_numpy(probe)).sum().backward()
    real = (tgt < V) & (w != 0)
    grad = np.zeros_like(msgs)
    grad[real] = w[real, None] * probe[tgt[real]]
    np.testing.assert_allclose(m.grad.numpy(), grad, rtol=1e-6, atol=1e-6)


# -- the factored energies ------------------------------------------------

# A shape where the JAX package takes _fused: n * k = 10,000 >= 8,192,
# V = 1,100 >= 1,024.
NE, KE, VE, DE = 1000, 10, 1100, 16


def energy_inputs(seed, single=False):
    """bf16 codes and factors, ids with hubs, coins, and cotangents."""
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((VE, DE)).astype(np.float32)
    q = rng.standard_normal((2, NE, DE)).astype(np.float32)
    ids = np.where(rng.random((NE, KE)) < 0.2, rng.integers(0, 5, (NE, KE)),
                   rng.integers(0, VE, (NE, KE))).astype(np.int32)
    co = rng.random((NE, KE)) < 0.5
    d_e = rng.standard_normal((NE, KE)).astype(np.float32)
    d_s = (0.01 * rng.standard_normal((NE, KE))).astype(np.float32)
    bf = jnp.bfloat16
    codes, q = jnp.asarray(codes, bf), jnp.asarray(q, bf)
    return codes, q, ids, co, d_e, d_s


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(BF16)
    return torch.from_numpy(a)


def energy_oracle(codes, qs, ids, co, d_e, d_s):
    """Energies, ev_sq and the gradients of sum(E dE + S dS) in float64
    from the same bf16 values; qs is (q_subj, q_obj) or (q,)."""
    c = np.asarray(codes, np.float64)
    q = [np.asarray(x, np.float64) for x in qs]
    ev = c[ids]
    sel = q[0][:, None, :] if len(q) == 1 else np.where(
        co[:, :, None], q[1][:, None, :], q[0][:, None, :])
    energy = (ev * sel).sum(-1)
    ev_sq = (ev * ev).sum(-1)
    d_codes = np.zeros_like(c)
    np.add.at(d_codes, ids.reshape(-1),
              (d_e[:, :, None] * sel + 2.0 * d_s[:, :, None] * ev)
              .reshape(-1, c.shape[1]))
    if len(q) == 1:
        d_q = [(d_e[:, :, None] * ev).sum(1)]
    else:
        d_q = [((d_e * ~co)[:, :, None] * ev).sum(1),
               ((d_e * co)[:, :, None] * ev).sum(1)]
    return energy, ev_sq, [d_codes] + d_q


@pytest.mark.parametrize("single", [False, True], ids=["binomial", "split"])
def test_fused_energies_and_backward_match_jax(single):
    """factored_negative_energies (the binomial loss) and
    single_factor_negative_energies (the split loss) at a shape where
    both packages take the fused backward: energies, ev_sq, d codes and
    d factors against JAX's and a float64 oracle; d codes go through
    kernel 3's plain version (an f32 sum) and are rounded to bf16."""
    codes, q, ids, co, d_e, d_s = energy_inputs(7 if single else 8)
    qs = (q[0],) if single else (q[0], q[1])
    if single:
        def jfn(c, q0):
            return jax_ne.single_factor_negative_energies(c, q0, ids)
        tfn = neg_energy.single_factor_negative_energies
    else:
        def jfn(c, q0, q1):
            return jax_ne.factored_negative_energies(c, q0, q1, ids, co)
        tfn = neg_energy.factored_negative_energies
    (want_e, want_s), vjp = jax.vjp(jfn, codes, *qs)
    want_g = vjp((jnp.asarray(d_e), jnp.asarray(d_s)))
    leaves = [to_torch(a).requires_grad_(True) for a in (codes,) + qs]
    t_ids = torch.from_numpy(ids)
    got_e, got_s = tfn(leaves[0], *leaves[1:], t_ids) if single else \
        tfn(*leaves, t_ids, torch.from_numpy(co))
    assert type(got_e.grad_fn).__name__.startswith(
        "_SingleFused" if single else "_Fused")
    grads = torch.autograd.grad(
        (got_e * torch.from_numpy(d_e)).sum()
        + (got_s * torch.from_numpy(d_s)).sum(), leaves)
    exact_e, exact_s, exact_g = energy_oracle(codes, qs, ids, co, d_e, d_s)
    assert_bar(got_e.detach().numpy(), want_e, exact_e, "energy")
    assert_bar(got_s.detach().numpy(), want_s, exact_s, "ev_sq")
    for name, g, w, e in zip(("d codes", "d q_subj", "d q_obj"), grads,
                             want_g, exact_g):
        assert g.dtype == BF16, name
        assert_bar(g.float().numpy(), np.asarray(w, np.float32), e, name)


def test_fused_code_grads_equal_an_index_add():
    """The fused backward's d codes before rounding: kernel 3's plain
    version over the CSR by id, plus codes times the per-id scalar sums,
    equal an f32 index_add_ of the same terms; padding-free ids that no
    entry names get zero."""
    rng = np.random.default_rng(9)
    v, n, d = 40, 300, 8
    codes = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    qcat = torch.from_numpy(rng.standard_normal((2 * n, d))
                            .astype(np.float32)).to(BF16)
    rows = torch.from_numpy(rng.integers(0, v - 3, n))
    fsel = torch.from_numpy(rng.integers(0, 2 * n, n))
    w_e = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    w_s = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    got = neg_energy._code_grads(codes, qcat, rows, w_e, w_s, fsel, None)
    want = torch.zeros(v, d).index_add_(
        0, rows, w_e[:, None] * qcat[fsel].float() + w_s[:, None]
        * codes[rows])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[v - 3:].any()


@pytest.mark.parametrize("single", [False, True], ids=["binomial", "split"])
@pytest.mark.parametrize("n, k, v, dtype", [
    (8192, 1, 1024, "bfloat16"), (8191, 1, 1024, "bfloat16"),
    (4096, 2, 1023, "bfloat16"), (4096, 2, 1024, "float32"),
    (100, 10, 5000, "bfloat16"), (1000, 10, 1100, "bfloat16")])
def test_dispatch_rule_is_jax(monkeypatch, single, n, k, v, dtype):
    """fused_backward_applies against the branch the JAX package takes,
    on both sides of each threshold (n * k at 8,192, V at 1,024, the
    dtype), and the port takes the branch it names."""
    taken = []
    fused, direct = (("_single_fused", "_single_direct") if single
                     else ("_fused", "_direct"))
    for name in (fused, direct):
        monkeypatch.setattr(jax_ne, name, lambda *a, name=name: (
            taken.append(name), (None, None))[1])
    d = 2
    jcodes = jnp.zeros((v, d), getattr(jnp, dtype))
    jq = jnp.zeros((n, d), getattr(jnp, dtype))
    ids = np.zeros((n, k), np.int32)
    co = np.zeros((n, k), bool)
    if single:
        jax_ne.single_factor_negative_energies(jcodes, jq, ids)
    else:
        jax_ne.factored_negative_energies(jcodes, jq, jq, ids, co)
    codes = torch.zeros(v, d, dtype=getattr(torch, dtype),
                        requires_grad=True)
    q = torch.zeros(n, d, dtype=codes.dtype)
    assert neg_energy.fused_backward_applies(codes, n, k) == \
        (taken == [fused])
    t_ids = torch.from_numpy(ids)
    energy, _ = (neg_energy.single_factor_negative_energies(codes, q, t_ids)
                 if single else neg_energy.factored_negative_energies(
                     codes, q, q, t_ids, torch.from_numpy(co)))
    assert (type(energy.grad_fn).__name__.lstrip("_").startswith(
        ("SingleFused" if single else "Fused"))) == (taken == [fused])


def test_kernels_take_one_input_dtype_each():
    """The wrappers' dtype rule: the gathered inputs all float32 (the f32
    entry point) or all bf16 (the bf16 one); a mix, or another dtype,
    raises before any launch. On CPU tensors the bf16 ops count no
    launch."""
    f32 = torch.zeros(2, 2)
    assert staircase.input_dtype("op", f32, f32) == torch.float32
    assert staircase.input_dtype("op", f32.to(BF16)) == BF16
    for bad in ((f32, f32.to(BF16)), (f32.half(),), (f32.double(),)):
        with pytest.raises(TypeError, match="float32 or all bfloat16"):
            staircase.input_dtype("op", *bad)
    jg, tg = graphs(0)
    before = (staircase2.block_direction.bf16_launches,
              staircase2.basis_direction.bf16_project_launches,
              staircase.staircase_aggregate.bf16_launches)
    staircase2.block_direction(torch.zeros(V, D), torch.zeros(R, N_BLOCKS,
                                                               DR, DR),
                               tg.fwd, V, compute_dtype=BF16)
    staircase2.basis_direction(torch.zeros(V, D_IN),
                               torch.zeros(D_IN, N_BASES * D_OUT),
                               torch.zeros(R, N_BASES), tg.fwd, V,
                               compute_dtype=BF16)
    staircase.staircase_aggregate(torch.zeros(tg.fwd.n_edges, D), tg.fwd, V,
                                  compute_dtype=BF16)
    assert (staircase2.block_direction.bf16_launches,
            staircase2.basis_direction.bf16_project_launches,
            staircase.staircase_aggregate.bf16_launches) == before
