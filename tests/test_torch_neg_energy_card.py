"""On the card: the float32 gather-dot route of the factored energies
(``ops/neg_energy.py``, ``csrc/neg_energy.cu``).

- The energies, ev_sq, d codes, d q_subj and d q_obj against a float64
  evaluation of the direct form (``chip_smoke.energies_exact``), at the
  R-GCN cells' n = 30,000, k = 10, d = 500 over V = 14,541 (FB15k-237)
  and V = 40,943 (WN18), at a small shape whose hub id fills 4 in 5
  slots (tens of thousands of entries on one id, and d = 37: the
  kernels' scalar path), and at k = 40 (two chunks of 32 entries). Each
  element may differ from its float64 value by gamma(m) * sum |terms|,
  gamma(m) = m u / (1 - m u) with u = 2^-24 and m the terms its f32 sum
  adds (d for an energy or ev_sq, k for a factor's gradient, the id's
  entries and 2 more for d codes): the bound on the rounding of any f32
  sum of m products in any order (Higham, Accuracy and Stability of
  Numerical Algorithms, 2002, eq. 3.5). The inputs are f32, so the
  float64 evaluation sees the same values. Run from the repository's
  root, which holds ``chip_smoke.py``.
- Two calls give the same bits.
- A forward and backward captured in a CUDA graph under
  ``torch.cuda.set_sync_debug_mode("error")`` replay to the eager bits.
- ``f32_launches`` and ``f32_grad_launches`` move once a call,
  ``bf16_launches`` does not, and ``gather.sum_by_csr`` launches kernel 3
  twice a backward.

The file imports no JAX: run it on the card with the repository's
conftest left out::

    python3 -m pytest --noconftest -m gpu tests/test_torch_neg_energy_card.py
"""
import pytest
import torch

from relationprediction_torch.device import exact_float32
from relationprediction_torch.ops import gather, neg_energy

pytestmark = pytest.mark.gpu

# name: (n, k, d, V, share of the slots taken by the hub id, or 0)
SHAPES = {"fb15k237": (30000, 10, 500, 14541, 0.0),
          "wn18": (30000, 10, 500, 40943, 0.0),
          "hub": (3000, 10, 37, 500, 0.8),
          "k40": (1000, 40, 64, 300, 0.0)}
FACTORED = neg_energy.factored_negative_energies
SINGLE = neg_energy.single_factor_negative_energies


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    exact_float32()
    return torch.device("cuda:0")


def inputs(card, n, k, d, v, hub, seed=0):
    """Codes and factors (leaves with gradients), the ids as the device
    draws give them ([k, n] int32 seen transposed), the coins, and the
    cotangents of the energies and of ev_sq."""
    g = torch.Generator(device=card).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=card)
    codes = normal(v, d).requires_grad_(True)
    q_subj = normal(n, d).requires_grad_(True)
    q_obj = normal(n, d).requires_grad_(True)
    ids = torch.randint(0, v, (k, n), generator=g, device=card,
                        dtype=torch.int32)
    if hub:
        ids = torch.where(torch.rand(k, n, generator=g, device=card) < hub,
                          7, ids)
    coin = torch.rand(k, n, generator=g, device=card) < 0.5
    return (codes, q_subj, q_obj, ids.t(), coin.t(), normal(n, k),
            normal(n, k))


def run(op, codes, q_subj, q_obj, ids, coin, d_e, d_s):
    """(energy, ev_sq, d codes, d q_subj[, d q_obj]) of one call."""
    leaves = (codes, q_subj) if op is SINGLE else (codes, q_subj, q_obj)
    energy, ev_sq = (op(codes, q_subj, ids) if op is SINGLE
                     else op(codes, q_subj, q_obj, ids, coin))
    grads = torch.autograd.grad((energy * d_e).sum() + (ev_sq * d_s).sum(),
                                leaves)
    return (energy, ev_sq) + grads


NAMES = ("energy", "ev_sq", "d_codes", "d_q_subj", "d_q_obj")
COUNTERS = ("f32_launches", "f32_grad_launches", "bf16_launches")


@pytest.mark.parametrize("shape, op", [
    *((shape, FACTORED) for shape in SHAPES),
    *((shape, SINGLE) for shape in ("fb15k237", "hub", "k40"))],
    ids=lambda x: x if isinstance(x, str) else
    ("factored" if x is FACTORED else "single"))
def test_route_holds_to_float64(card, shape, op):
    """Every result within its rounding allowance of the float64 direct
    form (the single-factor form at one cell's shape and the two small
    ones); each gather-dot kernel launched once, kernel 3 twice by
    sum_by_csr, the bf16 backward's kernel 3 never."""
    n, k, d, v, hub = SHAPES[shape]
    codes, q_subj, q_obj, ids, coin, d_e, d_s = inputs(card, n, k, d, v,
                                                       hub)
    before = {name: getattr(op, name) for name in COUNTERS}
    sums = gather.sum_by_csr.launches
    got = run(op, codes, q_subj, q_obj, ids, coin, d_e, d_s)
    torch.cuda.synchronize()
    assert {name: getattr(op, name) - before[name] for name in COUNTERS} \
        == {"f32_launches": 1, "f32_grad_launches": 1, "bf16_launches": 0}
    assert gather.sum_by_csr.launches - sums == 2
    import chip_smoke
    want = chip_smoke.energies_exact(
        codes, q_subj, None if op is SINGLE else q_obj, ids, coin, d_e, d_s)
    for name, g in zip(NAMES, got):
        value, allowance = want[name]
        assert g.dtype == torch.float32, name
        over = chip_smoke.over_allowance(g, value, allowance + 1e-30)
        assert over <= 1, f"{name}: {over} of the allowance"


def test_two_calls_give_the_same_bits(card):
    """The forward and the backward at the FB15k-237 cell's shape, twice:
    equal bit for bit."""
    args = inputs(card, *SHAPES["fb15k237"])
    first = run(FACTORED, *args)
    second = run(FACTORED, *args)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shape", ["hub", "fb15k237"])
def test_graph_replay_equals_eager(card, shape):
    """A forward and backward captured in a CUDA graph, with no host sync
    allowed in a warm call or in the capture, replays to the eager call's
    bits on the same inputs."""
    args = inputs(card, *SHAPES[shape])
    # Detached: an eager result that keeps its autograd graph keeps the
    # leaves' gradient nodes, made on another stream than the capture's.
    eager = [t.detach().clone() for t in run(FACTORED, *args)]
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(side):
            run(FACTORED, *args)
        torch.cuda.current_stream(card).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = run(FACTORED, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph.replay()
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, eager, captured):
        assert torch.equal(a, b), name
