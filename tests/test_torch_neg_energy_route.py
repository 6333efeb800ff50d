"""The float32 gather-dot route of the factored energies
(``ops/neg_energy.py``) on the CPU: which form ``energy_route`` sends each
call to, and the route's plain version (``gather_dot_reference``,
``gather_dot_grad_reference`` and ``_code_grads`` on kernel 3's plain
version) against autograd through the direct form, in float64. The card
runs the kernels: ``tests/test_torch_neg_energy_card.py``."""
import types

import pytest
import torch

from relationprediction_torch.ops import launch_counters, neg_energy

F64 = torch.float64
OPS = (neg_energy.factored_negative_energies,
       neg_energy.single_factor_negative_energies)


def codes_on(device: str, dtype, v: int = 2000, d: int = 8):
    """A stand-in for a [v, d] code table on ``device``: what the route
    reads of it, so a CUDA table needs no card."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 shape=(v, d))


@pytest.mark.parametrize("device, dtype, n, k, v, route", [
    ("cuda", torch.float32, 30000, 10, 14541, "gather_dot"),
    ("cuda", torch.float32, 3, 1, 5, "gather_dot"),
    ("cuda", torch.bfloat16, 30000, 10, 14541, "fused"),
    ("cuda", torch.bfloat16, 100, 10, 5000, "direct"),
    ("cuda", torch.float64, 30000, 10, 14541, "direct"),
    ("cpu", torch.float32, 30000, 10, 14541, "direct"),
    ("cpu", torch.float64, 30000, 10, 14541, "direct"),
    ("cpu", torch.bfloat16, 8192, 1, 1024, "fused"),
    ("cpu", torch.bfloat16, 8191, 1, 1024, "direct")])
def test_route_follows_device_and_dtype(device, dtype, n, k, v, route):
    """float32 codes on a card take the gather-dot at every size; bf16
    codes the fused form by the JAX package's rule on either device, else
    the direct form; every other call the direct form."""
    assert neg_energy.energy_route(codes_on(device, dtype, v), n, k) == route


@pytest.mark.parametrize("single", [False, True], ids=["factored", "single"])
def test_cpu_float32_calls_take_the_direct_form(single):
    """On the CPU a float32 call is the direct form, as before the route
    existed: its backward is autograd's, and no gather-dot counter
    moves."""
    codes, q, q2, ids, coin, _, _ = case("random", "distinct",
                                         torch.float32)
    before = launch_counters()
    energy, _ = (neg_energy.single_factor_negative_energies(codes, q, ids)
                 if single else neg_energy.factored_negative_energies(
                     codes, q, q2, ids, coin))
    assert "GatherDot" not in type(energy.grad_fn).__name__
    energy.sum().backward()
    assert launch_counters() == before


def case(coins: str, ids: str, dtype=F64, n: int = 60, k: int = 7,
         v: int = 40, d: int = 12, seed: int = 0):
    """(codes, q_subj, q_obj, ids, coin, d_energy, d_sq): codes and
    factors with gradients, ids ``distinct`` (spread over V, ids v-3.. v-1
    never drawn) or ``hub`` (4 in 5 slots one id), coins ``none`` (all
    False), ``all``, ``random`` or ``alternate``."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, dtype=F64).to(dtype)
    codes = normal(v, d).requires_grad_(True)
    q_subj = normal(n, d).requires_grad_(True)
    q_obj = normal(n, d).requires_grad_(True)
    neg = torch.randint(0, v - 3, (n, k), generator=g)
    if ids == "hub":
        neg = torch.where(torch.rand(n, k, generator=g) < 0.8, 5, neg)
    coin = {"none": torch.zeros(n, k, dtype=torch.bool),
            "all": torch.ones(n, k, dtype=torch.bool),
            "random": torch.rand(n, k, generator=g) < 0.5,
            "alternate": (torch.arange(n * k) % 2 == 1).view(n, k)}[coins]
    return (codes, q_subj, q_obj, neg, coin, normal(n, k), normal(n, k))


@pytest.mark.parametrize("ids", ["distinct", "hub"])
@pytest.mark.parametrize("coins", ["none", "all", "random", "alternate",
                                   "single"])
def test_route_matches_autograd_of_the_direct_form(coins, ids):
    """The route (``_GatherDot`` on CPU tensors: the kernels' plain
    versions, d codes by ``_code_grads`` over the CSR by id) against
    autograd through the direct form (``direct_energies``, every CPU
    call's), both in float64: the energies, ev_sq
    and the gradients of the codes and both factors (of the one factor
    for the single-factor form), to float64 rounding. Ids never drawn get
    a zero gradient."""
    single = coins == "single"
    codes, q_subj, q_obj, neg, coin, d_e, d_s = case(
        "none" if single else coins, ids)
    leaves = (codes, q_subj) if single else (codes, q_subj, q_obj)
    op = OPS[1] if single else OPS[0]
    got = neg_energy._GatherDot.apply(
        codes, q_subj, None if single else q_obj, neg,
        None if single else coin, op)
    want = neg_energy.direct_energies(
        codes, neg, q_subj, None if single else q_obj, coin)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)

    def grads(out):
        return torch.autograd.grad((out[0] * d_e).sum() + (out[1] * d_s)
                                   .sum(), leaves)
    got_g = grads(got)
    for name, g, w in zip(("codes", "q_subj", "q_obj"), got_g,
                          grads(want)):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12, msg=name)
    assert not got_g[0][-3:].any()


def test_route_saves_no_gathered_rows():
    """What the route keeps for its backward: the codes, the factors, the
    ids and the coins; no tensor of n * k * d elements."""
    codes, q_subj, q_obj, neg, coin, _, _ = case("random", "hub")
    n, k = neg.shape
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: (saved.append(tuple(t.shape)), t)[1], lambda t: t):
        neg_energy._GatherDot.apply(codes, q_subj, q_obj, neg, coin, OPS[0])
    assert saved and all(torch.Size(s).numel() < n * k * codes.shape[1]
                         for s in saved)
    assert sorted(saved) == sorted([tuple(codes.shape), (n, codes.shape[1]),
                                    (n, codes.shape[1]), (n, k), (n, k)])


@pytest.mark.parametrize("op", OPS, ids=lambda op: op.__name__)
def test_each_energy_op_counts_its_kernels(op):
    """Each energies op carries its gather-dot counters beside its bf16
    one, found by ``ops.launch_counters``."""
    counters = launch_counters()
    for name in ("bf16_launches", "f32_launches", "f32_grad_launches"):
        assert counters[(op, name)] == getattr(op, name)


def test_check_refuses_what_the_kernels_do_not_take():
    """The kernels' input rules, checked before a launch: int64 ids of
    the coins' shape, float32 factors of the codes' width, contiguous."""
    codes, q_subj, q_obj, neg, coin, d_e, _ = case("random", "distinct",
                                                   torch.float32)
    codes, q_subj, q_obj = (t.detach() for t in (codes, q_subj, q_obj))
    rows = {"q_subj": q_subj, "q_obj": q_obj}
    neg_energy._check(codes, neg, coin, rows)
    neg_energy._check(codes, neg, None, {"q_subj": q_subj, "q_obj": None})
    neg_energy._check(codes, neg, coin, {"d_energy": d_e.float()})
    bad = [((codes, neg.int(), coin, rows), TypeError),
           ((codes.double(), neg, coin, rows), TypeError),
           ((codes, neg, coin[:, :-1], rows), ValueError),
           ((codes, neg.t().contiguous().t(), coin, rows), ValueError),
           ((codes, neg, coin, {"q_subj": q_subj[:, :-1], "q_obj": q_obj}),
            ValueError),
           ((codes, neg, coin, {"q_subj": q_subj, "q_obj": q_obj[1:]}),
            ValueError),
           ((codes, neg, coin, {"d_energy": d_e.float()[:, :-1]}),
            ValueError)]
    for args, error in bad:
        with pytest.raises(error):
            neg_energy._check(*args)
