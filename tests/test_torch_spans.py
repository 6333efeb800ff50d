"""The port's spans (``observability.span``): what a sink holds, the
thread CPU clock beside the wall clock, profiler ranges only while a
profiler records, and the spans of ``TrainLoop.fit``'s records."""
import dataclasses
import json
import os
import threading
import time
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from relationprediction_torch import config as torch_config
from relationprediction_torch import observability
from relationprediction_torch.data import dataset as torch_dataset
from relationprediction_torch.models.build import build_model
from relationprediction_torch.observability import collect, span
from relationprediction_torch.training.engine import TrainLoop

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")

# What each step of a CPU fit of gcn_block records on the main thread,
# and what its batch's producer records.
STEP_SPANS = {"fit.step", "fit.batch_wait", "fit.train_step", "step.draws",
              "step.forward", "model.encode", "step.backward",
              "step.optimizer"}
BATCH_SPANS = {"batch.build", "batch.sample", "batch.graph"}


def small_loop(prefetch=True, scores=None):
    """A TrainLoop of gcn_block.exp cut to d=20, B=4 on data/Toy; with
    ``scores``, a validation check every 2 steps."""
    ds = torch_dataset.load(os.path.join(ROOT, "data", "Toy"))
    cfg = torch_config.load(os.path.join(ROOT, "settings", "gcn_block.exp"))
    cfg = dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, code_dimension=20,
                                    internal_dimension=20, n_bases=4),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
        optimizer=dataclasses.replace(cfg.optimizer,
                                      report_train_loss_every=3,
                                      early_stopping_check_every=2),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))
    scoring = None if scores is None else (lambda params: next(scores))
    return TrainLoop(build_model(cfg, CPU), cfg, ds, seed=0,
                     log=lambda _: None, prefetch=prefetch,
                     scoring_function=scoring)


def test_nested_spans_add_into_the_right_sink():
    with collect() as outer:
        with span("a"):
            for _ in range(2):
                with span("b"):
                    pass
            with collect() as inner:
                with span("c"):
                    pass
            with span("b"):
                pass
    assert set(outer) == {"a", "b"} and set(inner) == {"c"}
    assert outer["a"][2] == 1 and outer["b"][2] == 3 and inner["c"][2] == 1
    assert outer["a"][0] >= outer["b"][0] + inner["c"][0]
    assert all(isinstance(x, int) and x >= 0
               for v in (outer["a"], outer["b"]) for x in v)
    # the sink is uninstalled at the end: a later span records nothing
    with span("a"):
        pass
    assert outer["a"][2] == 1


@pytest.mark.parametrize("work", ["sleep", "busy"])
def test_thread_cpu_beside_wall(work):
    """A sleep is wall time the thread spends off the CPU; a busy loop
    runs on it (up to preemption by other processes)."""
    with collect() as sink, span(work):
        if work == "sleep":
            time.sleep(0.2)
        else:
            end = time.thread_time() + 0.2
            while time.thread_time() < end:
                pass
    wall, cpu, _ = sink[work]
    assert wall >= 0.2e9
    if work == "sleep":
        assert cpu < 0.05 * wall
    else:
        assert 0.25 * wall <= cpu <= wall


def test_a_thread_without_a_sink_records_nothing():
    seen = {}

    def other():
        with span("elsewhere"):
            pass
        seen["sink"] = observability._local.sink

    with collect() as sink:
        thread = threading.Thread(target=other)
        thread.start()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert sink == {} and seen["sink"] is None


def test_ranges_only_while_a_profiler_records():
    """No ``record_function`` outside a profiler, nor in a schedule's idle
    and warm-up steps; one a span in its recorded steps."""
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    with mock.patch.object(torch.profiler, "record_function", counting):
        with collect() as sink:
            for _ in range(3):
                with span("off"):
                    pass
        assert entered == [] and sink["off"][2] == 3
        states = []
        with profile(activities=[ProfilerActivity.CPU],
                     schedule=schedule(wait=2, warmup=1, active=2,
                                       repeat=1)) as prof:
            for step in range(7):
                states.append(observability._profiling())
                with span(f"step{step}"):
                    pass
                prof.step()
    assert states == [False, False, False, True, True, False, False]
    assert entered == ["step3", "step4"]


def test_chrome_trace_holds_the_step_spans(tmp_path):
    loop = small_loop(prefetch=False)
    params, opt_state = loop.init_state()
    with observability.trace(str(tmp_path)) as path:
        loop.fit(params, opt_state, max_iterations=1)
    events = [e for e in json.loads(open(path).read())["traceEvents"]
              if e.get("ph") == "X"]

    def one(name):
        found = [e for e in events if e["name"] == name]
        assert len(found) == 1, name
        return found[0]

    def inside(e, outer):
        return e["tid"] == outer["tid"] and outer["ts"] <= e["ts"] \
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    train, fwd, enc, bwd = (one(n) for n in (
        "fit.train_step", "step.forward", "model.encode", "step.backward"))
    assert inside(fwd, train) and inside(enc, fwd) and inside(bwd, train)
    # the loop's last pass opens a fit.step too, and leaves at its top
    assert any(inside(train, e) for e in events if e["name"] == "fit.step")
    aten = [e for e in events if e["name"].startswith("aten::")]
    for outer in (fwd, enc):
        assert any(inside(e, outer) for e in aten), outer["name"]
    assert any(inside(e, one("step.optimizer")) for e in aten)


@pytest.mark.parametrize("prefetch", [True, False])
def test_fit_records_hold_the_spans(tmp_path, prefetch):
    """Every step records the main thread's spans and its batch's
    producer's; ``wait_ms`` and ``batch_ms`` are the wall times of
    ``fit.batch_wait`` and ``batch.build``; ``StepTimer`` counts the
    ``fit.step`` spans."""
    loop = small_loop(prefetch=prefetch, scores=iter([0.1, 0.2]))
    result = loop.fit(max_iterations=4,
                      checkpoint_path=str(tmp_path / "m"))
    steps = result.steps
    assert [s["iteration"] for s in steps] == [1, 2, 3, 4]
    batch_names = BATCH_SPANS | ({"batch.copy"} if not prefetch else set())
    for s in steps:
        spans, built = s["spans"], s["batch_spans"]
        assert STEP_SPANS <= set(spans), set(spans)
        assert set(built) == batch_names
        assert s["wait_ms"] == spans["fit.batch_wait"][0]
        assert s["batch_ms"] == built["batch.build"][0]
        assert all(n == 1 for name, (_, _, n) in spans.items()
                   if name in STEP_SPANS)
        assert spans["fit.step"][0] >= spans["fit.train_step"][0] \
            + spans["fit.batch_wait"][0]
        assert spans["fit.train_step"][0] >= spans["step.forward"][0] \
            + spans["step.backward"][0] + spans["step.optimizer"][0]
        assert spans["step.forward"][0] >= spans["model.encode"][0]
        json.dumps(s)
    # the loss reads at iteration 1 and at the reporting cadence (4 % 3
    # == 1), before each check; the checks and saves every 2 steps
    assert [("fit.pending" in s["spans"]) for s in steps] == [True, True,
                                                             False, True]
    assert [("fit.check" in s["spans"]) for s in steps] == [False, True,
                                                           False, True]
    assert [("fit.save" in s["spans"]) for s in steps] == [False, True,
                                                          False, True]
    stats = loop.timer.stats
    assert stats.steps == 4
    assert stats.total_seconds == pytest.approx(
        sum(s["spans"]["fit.step"][0] for s in steps) * 1e-3)
    assert stats.total_seconds * 1e3 > sum(
        s["spans"]["fit.train_step"][0] for s in steps)
