"""The 1-N cell (``compgcn_conve.fb15k237.kvsall``): its counts of work
and bytes against hand counts, its run on the toy graph on the CPU (the
port against the reference, and the readers of its readings), the faults
planted in the port that must come out not correct, and, on the card, 40
replayed steps against 40 eager ones, bit for bit."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import bounds, bounds_compgcn, harness, work_compgcn
from portbench.paths import train_kvsall
from portbench.tests.toy import toy_run

CELL = "compgcn_conve.fb15k237.kvsall"


def test_sum_bound_counts_the_launch():
    # 5 entries of d = 4 into 3 rows, weighted and not permuted: the
    # entries, the output, the row pointers and the weights.
    b = bounds_compgcn.sum_bound(3, 5, 4, True, False)
    assert b["bytes"] == 4 * (5 * 4 + 3 * 4 + 4 + 5)
    assert b["ops"] == 2 * 5 * 4
    p = bounds_compgcn.sum_bound(3, 5, 4, False, True)
    assert (p["bytes"], p["ops"]) == (4 * (20 + 12 + 4 + 5), 20)
    graph = SimpleNamespace(inward=SimpleNamespace(n_edges=5),
                            outward=SimpleNamespace(n_edges=4),
                            n_vertices=3, n_relations=2)
    launches = bounds_compgcn.step_launches(graph, 8, 12)
    assert launches == [(3, 5, 12, True, False), (3, 4, 12, True, False),
                        (3, 9, 8, False, True), (4, 9, 8, False, True)]
    assert bounds_compgcn.step_least_s(launches) == pytest.approx(sum(
        bounds_compgcn.sum_bound(*x)["bound_s"] for x in launches))
    assert bounds_compgcn.sum_bound(3, 5, 4, True, False)["bound_s"] == \
        pytest.approx(bounds.least_time(b["bytes"], b["ops"])["bound_s"])


def test_step_flops_by_hand():
    shape = {"d_in": 2, "d": 3, "n_vertices": 4, "n_relations": 1,
             "kernel": 2, "n_filters": 1, "conv_height": 2,
             "conv_width": 1}
    # 6 compositions (2 message edges + 4 self-loops): 2 d_in^2 + 2 d_in d
    # each; 2 messages summed at 2 d; the relations 2 (2R) d_in d; a query:
    # 2 k^2 F (H W) + 2 F (H W) d + 2 d V.
    encode = 6 * (8 + 12) + 2 * 6 + 2 * 2 * 2 * 3
    query = 2 * 4 * 1 * 2 + 2 * 1 * 2 * 3 + 2 * 3 * 4
    assert work_compgcn.forward_flops(shape, 6, 5) == encode + 5 * query
    assert work_compgcn.train_step_flops(shape, 6, 5) == \
        3 * (encode + 5 * query)


@pytest.fixture(scope="module")
def sound():
    return toy_run(CELL, seed=2 ** 31 + 21)


def test_toy_run_is_correct_and_read(sound):
    outcome, run = sound
    c = {k: v["value"] for k, v in outcome.compared.items()}
    # f32 sums in other orders: the FFT against the circulant, CSR order
    # against index_add.
    assert c["loss_gap"] < 1e-5 and c["window_loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-5 and c["change_gap"] < 1e-3
    assert c["inputs_off"] == 0 and outcome.correct
    r = outcome.readings
    assert {s["queries"] for s in r.steps} == {128}
    for name, found in (("batch_wait_ms.train", True),
                        ("host_batch_ms.train", True),
                        ("compgcn_train_mfu", True),
                        ("device_step_ms.train", False),
                        ("compgcn_aggregate_roofline.train", False)):
        got = harness.load_metric(name).read(r)
        assert (got is not None) == found, name
    line = harness.result_line(harness.load_benchmark(), run.cell, outcome,
                               False, "cpu", 1)
    assert set(line["metrics"]) == {"train_triples_per_s", "setup_s"}


def test_control_and_faults_fail_the_limits(sound):
    """In each run of checked steps, the half batch and the unchanged
    state put in the program's place fail a number the cell compares
    (the control, TF32, needs the card)."""
    _, run = sound
    for at, kept in run.kept.items():
        for what, numbers in train_kvsall.study_readings(kept).items():
            if what == "control":
                continue
            assert any(c["value"] > run.limits[train_kvsall.prefix(at) + k]
                       for k, c in numbers.items()), (at, what)


def unchanged_state(monkeypatch):
    from relationprediction_torch.training import engine

    def step(self, params, opt_state, batch):
        self.draw(batch)
        return opt_state, torch.tensor(0.7)
    monkeypatch.setattr(engine.TrainLoop, "train_step", step)


def half_batch(monkeypatch):
    """Half of each batch's queries left out of the mean."""
    from relationprediction_torch.training import engine
    inner = engine.step_loss_and_grads

    def step(model, kind, params, batch, draws, group=None):
        mask = batch.mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return inner(model, kind, params, batch._replace(mask=mask), draws,
                     group)
    monkeypatch.setattr(engine, "step_loss_and_grads", step)


def wrong_direction(monkeypatch):
    """Each half's messages sent the other way: into the object from the
    subject with relation r, and into the subject with r + R."""
    from relationprediction_torch import graph as graph_lib
    from relationprediction_torch.models import build
    inner = graph_lib.build_compgcn_graph

    def swapped(triples, n_vertices, n_relations):
        t = np.asarray(triples)[:, [2, 1, 0]]
        return inner(t, n_vertices, n_relations)
    monkeypatch.setattr(build, "build_compgcn_graph", swapped)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   wrong_direction])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    outcome, _ = toy_run(CELL)
    assert not outcome.correct


@pytest.mark.gpu
def test_replayed_steps_equal_eager_steps_on_the_card():
    """40 steps of the cell's loop on the fitted graph, replayed as one CUDA
    graph, against the same 40 steps op by op: losses, params, Adam's state
    and the running statistics equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from relationprediction_torch.models.build import build_model
    from relationprediction_torch.params import tree_leaves
    from relationprediction_torch.training.engine import TrainLoop
    from portbench import weights_compgcn
    from portbench.paths.common import dataset, port_config
    from portbench.reference import compgcn as ref

    device = torch.device("cuda:0")
    cell = harness.load_cell(CELL)
    traffic, settings = cell["traffic_file"], cell["config_file"]["settings"]
    ds = dataset(traffic, 2 ** 31 + 7)
    cfg = port_config(settings).with_counts(ds.n_entities, ds.n_relations,
                                            len(ds.train))
    spec = ref.spec_from_settings(settings)
    sides = []
    for graphs in (True, False):
        model = build_model(cfg, device)
        loop = TrainLoop(model, cfg, ds, seed=5, log=lambda _: None,
                         prefetch=False)
        loop.graphs.enabled = graphs
        params = weights_compgcn.make_params(spec, ds.n_entities,
                                             ds.n_relations, 9, device)
        result = loop.fit(params, loop.optimizer.init(params),
                          max_iterations=40)
        sides.append(([s["loss"] for s in result.steps],
                      [t.cpu() for t in tree_leaves(result.params)
                       + tree_leaves(result.opt_state)
                       + tree_leaves(model.batch_stats)],
                      dict(loop.graph_counts)))
    (loss_a, leaves_a, counts_a), (loss_b, leaves_b, counts_b) = sides
    assert counts_a == {"captures": 1, "replays": 37, "eager": 2,
                        "failed_captures": 0}
    assert counts_b["eager"] == 40 and counts_b["replays"] == 0
    assert loss_a == loss_b
    assert all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))
