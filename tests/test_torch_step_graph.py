"""The single-card step as one CUDA graph, its parts that run without a
card: ``staircase.row_of_entry`` with the entry count from the layout's
shape, Adam's decays made on the device once, the rule that says which
steps may take a graph, the signature a graph is kept under, the one
graph a loop keeps, the launch counters a replay adds to, and
``TrainLoop.fit`` on the CPU, whose every step runs op by op. The card's
own checks (replay against eager bit for bit, no host sync in a warm step,
a resume in the middle of a replayed run) are in
``test_torch_step_graph_card.py``."""
import dataclasses
import gc
import os
import weakref

import numpy as np
import pytest
import torch

from relationprediction_torch import config as torch_config
from relationprediction_torch.config import OptimizerConfig
from relationprediction_torch.data import dataset as torch_dataset
from relationprediction_torch.graph import CsrLayout, build_graph_batch
from relationprediction_torch.models.build import EncoderNoise, build_model
from relationprediction_torch.ops import (
    add_launches, gather, launch_counters, neg_energy, staircase, staircase2)
from relationprediction_torch.params import map_tree, tree_leaves
from relationprediction_torch.training.engine import (
    GRAPH_WARMUP_STEPS, Draws, StepGraphs, TrainBatch, TrainLoop,
    graph_applies, step_signature)
from relationprediction_torch.training.optimizers import build_optimizer

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")


def random_csr(n_rows, n_edges, seed, empty_rows=()):
    """A CSR layout of ``n_edges`` entries over ``n_rows`` rows, none in
    ``empty_rows``."""
    gen = torch.Generator().manual_seed(seed)
    rows = [r for r in range(n_rows) if r not in set(empty_rows)]
    targets = torch.tensor(rows)[torch.randint(len(rows), (n_edges,),
                                                generator=gen)] \
        if n_edges else torch.zeros(0, dtype=torch.int64)
    counts = torch.bincount(targets, minlength=n_rows)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int32)
    row_ptr[1:] = torch.cumsum(counts, 0)
    ids = torch.zeros(n_edges, dtype=torch.int32)
    return CsrLayout(row_ptr=row_ptr, src=ids, rel=ids,
                     w=torch.ones(n_edges))


@pytest.mark.parametrize("n_rows,n_edges,empty", [
    (7, 40, ()), (50, 300, (0, 3, 4, 49)), (12, 5, (1, 2, 3, 4, 5, 6)),
    (9, 0, ()), (0, 0, ())],
    ids=["dense", "empty_rows", "mostly_empty", "no_entries", "no_rows"])
def test_row_of_entry_is_the_expansion_without_a_host_read(n_rows, n_edges,
                                                           empty):
    """The rows from the layout's shape equal the expansion that reads
    its entry count from row_ptr (the form before)."""
    layout = random_csr(n_rows, n_edges, seed=n_rows + n_edges,
                        empty_rows=empty)
    want = torch.repeat_interleave(torch.arange(layout.n_rows),
                                   layout.row_ptr.diff().long())
    got = staircase.row_of_entry(layout)
    assert got.dtype == want.dtype and torch.equal(got, want)


def old_adam_update(g, state, b1=0.9, b2=0.999, eps=1e-8):
    """Adam's update as it was, its decays made from host floats at every
    step."""
    mu = [(1 - b1) * x + b1 * m for x, m in zip(g, state["mu"])]
    nu = [(1 - b2) * (x * x) + b2 * v for x, v in zip(g, state["nu"])]
    count = state["count"] + 1
    c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
    c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
    return ([(m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)],
            {"count": count, "mu": mu, "nu": nu})


@pytest.mark.parametrize("betas", [{}, {"beta1": 0.5, "beta2": 0.98}],
                         ids=["defaults", "other_decays"])
def test_adam_with_decays_made_once_equals_the_old_update(betas):
    """Five steps of the port's Adam (clip 1) against the old update on the
    same clipped gradients, bit for bit."""
    cfg = OptimizerConfig(algorithm="Adam", learning_rate=0.01,
                          max_gradient_norm=1.0, algorithm_kwargs=betas)
    opt = build_optimizer(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(6, 4, generator=gen),
              "b": torch.randn(5, generator=gen)}
    state = opt.init(params)
    old = {"count": state["count"].clone(),
           "mu": [t.clone() for t in tree_leaves(state["mu"])],
           "nu": [t.clone() for t in tree_leaves(state["nu"])]}
    b = dict(b1=betas.get("beta1", 0.9), b2=betas.get("beta2", 0.999))
    for step in range(5):
        grads = map_tree(lambda p: 3.0 * torch.randn(p.shape, generator=gen),
                         params)
        updates, state = opt.update(grads, state)
        clipped = tree_leaves(grads)
        norm = torch.sqrt(sum((x * x).sum() for x in clipped))
        clipped = [torch.where(norm < 1.0, x, (x / norm) * 1.0)
                   for x in clipped]
        want, old = old_adam_update(clipped, old, **b)
        for got, w in zip(tree_leaves(updates), want):
            assert torch.equal(got, w * -0.01), step
        assert torch.equal(state["count"], old["count"])
        for key in ("mu", "nu"):
            for got, w in zip(tree_leaves(state[key]), old[key]):
                assert torch.equal(got, w), (step, key)


@pytest.mark.parametrize("device,mesh,vertex_sharded,has_state,want", [
    ("cuda:0", None, False, False, True),
    ("cuda", None, False, False, True),
    ("cpu", None, False, False, False),
    ("cuda:0", "mesh", False, False, False),
    ("cuda:0", "mesh", True, False, False),
    ("cuda:0", None, False, True, False)],
    ids=["card", "card_no_index", "cpu", "mesh", "vertex_sharded",
         "stored_messages"])
def test_only_a_single_card_step_takes_the_graph(device, mesh,
                                                 vertex_sharded, has_state,
                                                 want):
    assert graph_applies(device, mesh, vertex_sharded, has_state) is want


def toy_batch(n_pos=8, v=10, with_graph=True, labels=False):
    """A small batch and its draws on the CPU."""
    rng = np.random.default_rng(0)
    triples = np.stack([rng.integers(0, v, 20), rng.integers(0, 3, 20),
                        rng.integers(0, v, 20)], 1)
    graph = build_graph_batch(triples, v, 3) if with_graph else None
    batch = TrainBatch(graph, torch.zeros(n_pos, 3, dtype=torch.int32),
                       torch.ones(n_pos),
                       labels=torch.ones(n_pos) if labels else None)
    draws = Draws((torch.zeros(n_pos, 10, dtype=torch.int64),
                   torch.zeros(n_pos, dtype=torch.bool)),
                  [torch.ones(v, 4, dtype=torch.bool)] * 2, EncoderNoise())
    return batch, draws


def params_tree():
    return {"W": torch.zeros(10, 4), "b": torch.zeros(4)}


def test_signature_holds_shapes_dtypes_and_storage():
    """Steps of one shape on the same params share a key; another shape,
    dtype, absent tensor, loss kind or params storage gives another."""
    params = params_tree()
    batch, draws = toy_batch()
    key = step_signature("factored", params, batch, draws)
    again = toy_batch()
    assert step_signature("factored", params, *again) == key
    others = [
        step_signature("split", params, batch, draws),
        step_signature("factored", params, *toy_batch(n_pos=16)),
        step_signature("factored", params, *toy_batch(labels=True)),
        step_signature("factored", params, *toy_batch(with_graph=False)),
        step_signature("factored", params_tree(), batch, draws),
        step_signature("factored", params, batch._replace(
            mask=batch.mask.double()), draws),
        step_signature("factored", params, batch, draws._replace(
            keep_masks=draws.keep_masks[:1])),
        step_signature("factored", params, batch, draws._replace(
            noise=EncoderNoise(eps=torch.zeros(10, 4))))]
    assert all(k != key for k in others)
    assert len(set(others)) == len(others)


def test_route_warms_up_captures_replays_and_starts_again_on_a_new_key():
    """A signature's GRAPH_WARMUP_STEPS eager steps, a capture, then
    replays; a step of another signature drops the graph and warms up
    anew, and a return to the first does the same; ``release`` drops it
    too; with graphs off every step is eager."""
    graphs = StepGraphs(True, lambda _: None)
    want = ["warmup"] * GRAPH_WARMUP_STEPS + ["capture"]
    for key in ("first", "second", "first"):
        assert [graphs.route(key) for _ in want] == want
        graphs.current.graph = object()  # as a capture leaves it
        assert [graphs.route(key) for _ in range(3)] == ["replay"] * 3
        assert graphs.current.key == key
    graphs.release()
    assert graphs.current is None
    assert graphs.route("first") == "warmup"
    off = StepGraphs(False, lambda _: None)
    assert [off.route(0) for _ in range(5)] == ["eager"] * 5
    assert off.current is None


COUNTED_OPS = [staircase.staircase_aggregate, gather.sum_by_csr,
               neg_energy.factored_negative_energies,
               neg_energy.single_factor_negative_energies,
               staircase2.block_direction, staircase2.basis_direction,
               staircase2.scatter2, staircase2.scatter2_slot_order]


@pytest.mark.parametrize("op", COUNTED_OPS, ids=lambda op: op.__name__)
def test_launch_counters_hold_every_counter_of_an_op(op):
    """``launch_counters`` finds each counter of the ops that launch
    kernels, and nothing that is no counter."""
    counters = launch_counters()
    names = {name for name in vars(op) if name.endswith("launches")}
    assert names and {name for fn, name in counters if fn is op} == names
    assert all(isinstance(n, int) for n in counters.values())
    assert {fn for fn, _ in counters} == set(COUNTED_OPS)


def test_a_replay_adds_the_launches_its_capture_counted():
    """Adding a capture's differences counts the replayed kernels as the
    eager step would."""
    before, counts = launch_counters(), staircase2.launch_counts()
    recorded = {(staircase2.block_direction, "launches"): 4,
                (staircase2.block_direction, "twin_launches"): 4,
                (staircase.staircase_aggregate, "fixup_launches"): 2}
    try:
        add_launches(recorded)
        after = launch_counters()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == recorded
        assert staircase2.launch_counts() == (counts[0] + 4, counts[1] + 4)
    finally:
        add_launches({k: -n for k, n in recorded.items()})
    assert launch_counters() == before


def small_loop(prefetch):
    """gcn_block.exp cut to d=20, B=4 on data/Toy, on the CPU."""
    ds = torch_dataset.load(os.path.join(ROOT, "data", "Toy"))
    cfg = torch_config.load(os.path.join(ROOT, "settings", "gcn_block.exp"))
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, code_dimension=20,
                                         internal_dimension=20, n_bases=4),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))
    return TrainLoop(build_model(cfg, CPU), cfg, ds, seed=0,
                     log=lambda _: None, prefetch=prefetch)


@pytest.mark.parametrize("prefetch", [True, False])
def test_fit_on_the_cpu_runs_every_step_eagerly(prefetch):
    loop = small_loop(prefetch)
    steps = GRAPH_WARMUP_STEPS + 2  # as far as a card's first replay
    result = loop.fit(max_iterations=steps)
    assert [s["graph"] for s in result.steps] == ["eager"] * steps
    assert loop.graph_counts == {"captures": 0, "replays": 0,
                                 "eager": steps,
                                 "failed_captures": 0}
    assert loop.graphs.current is None
    assert all("step.replay" not in s["spans"] for s in result.steps)
    # No reference cycle keeps a loop (on the card, its graph's memory
    # pool) once its last reference goes.
    gc.collect()
    gc.disable()
    try:
        ref = weakref.ref(loop)
        del loop
        assert ref() is None
    finally:
        gc.enable()


def test_in_place_step_writes_the_eager_steps_state():
    """``in_place_step`` leaves in the given state's tensors the bits that
    ``eager_step`` returns, step after step, with the same params and
    losses."""
    eager, in_place = small_loop(False), small_loop(False)
    p_e, s_e = eager.init_state(0)
    p_i, s_i = in_place.init_state(0)
    state_tensors = tree_leaves(s_i)
    for _ in range(2):
        b_e, b_i = eager.pipeline.next(), in_place.pipeline.next()
        s_e, loss_e = eager.eager_step(p_e, s_e, b_e, eager.draw(b_e))
        loss_i = in_place.in_place_step(p_i, s_i, b_i, in_place.draw(b_i))
        assert torch.equal(loss_e, loss_i)
        assert all(a is b for a, b in zip(tree_leaves(s_i), state_tensors))
        for a, b in zip(tree_leaves((p_e, s_e)), tree_leaves((p_i, s_i))):
            assert torch.equal(a, b)
