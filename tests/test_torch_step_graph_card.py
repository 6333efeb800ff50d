"""On the card: the single-card train step replayed as one CUDA graph
against the same step op by op, on the full-width ``gcn_block.exp`` and
``gcn_basis.exp`` (float32) on the seeded ``synth:FB15k-237`` graph.

- 40 steps from one seed, replayed against eager: the losses and the
  params after every step equal bit for bit;
- a warm step runs under ``torch.cuda.set_sync_debug_mode("error")``: no
  operation of the step waits for the card on the host;
- a resume from a checkpoint in the middle of a replayed run equals the
  continuous run (its first steps op by op, then its own capture);
- no producer's copy stream is the stream that captures the step.

The file imports no JAX: run it on the card with the repository's
conftest left out (it forces JAX onto the CPU, and the card's machine has
no JAX)::

    python3 -m pytest --noconftest -m gpu tests/test_torch_step_graph_card.py
"""
import dataclasses
import hashlib
from pathlib import Path

import pytest
import torch

from relationprediction_torch import config
from relationprediction_torch.data import synthetic
from relationprediction_torch.device import exact_float32
from relationprediction_torch.models import build
from relationprediction_torch.params import tree_leaves
from relationprediction_torch.training import engine

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = {"gcn_block": ROOT / "settings" / "gcn_block.exp",
            "gcn_basis": ROOT / "settings" / "gcn_basis.exp"}
STEPS = 40
RESUME_STEPS = 20


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    exact_float32()
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def dataset(card):
    return synthetic.like("FB15k-237", seed=0)


def settings(name, ds, **optimizer):
    cfg = config.load(str(SETTINGS[name])).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, **optimizer))


def new_loop(cfg, ds, device, prefetch=False):
    return engine.TrainLoop(build.build_model(cfg, device), cfg, ds, seed=0,
                            log=lambda line: None, prefetch=prefetch)


def digest(params, opt_state, loss) -> str:
    h = hashlib.sha256()
    for t in tree_leaves(params) + tree_leaves(opt_state) + [loss]:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def stepped(loop, graph: bool) -> list:
    """Make ``loop.train_step`` op by op unless ``graph``, and record the
    digest of the params, the optimizer state and the loss after each
    step."""
    inner = loop.train_step if graph else (
        lambda p, s, b: loop.eager_step(p, s, b, loop.draw(b)))
    after = []

    def train_step(params, opt_state, batch):
        opt_state, loss = inner(params, opt_state, batch)
        after.append(digest(params, opt_state, loss))
        return opt_state, loss
    loop.train_step = train_step
    return after


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_replayed_steps_equal_the_eager_steps(card, dataset, name):
    cfg = settings(name, dataset)
    runs = {}
    for graph in (True, False):
        loop = new_loop(cfg, dataset, card)
        after = stepped(loop, graph)
        result = loop.fit(max_iterations=STEPS)
        runs[graph] = (loop, result, after)
    loop, result, after = runs[True]
    warm = engine.GRAPH_WARMUP_STEPS
    assert [s["graph"] for s in result.steps] \
        == ["eager"] * warm + ["capture"] + ["replay"] * (STEPS - warm - 1)
    assert loop.graph_counts == {"captures": 1, "replays": STEPS - warm - 1,
                                 "eager": warm, "failed_captures": 0}
    eager = runs[False][1]
    assert [s["loss"] for s in result.steps] \
        == [s["loss"] for s in eager.steps]
    assert [s["launches"] for s in result.steps] \
        == [s["launches"] for s in eager.steps]
    assert [s["twin_launches"] for s in result.steps] \
        == [s["twin_launches"] for s in eager.steps]
    differ = [i + 1 for i, (a, b) in enumerate(zip(after, runs[False][2]))
              if a != b]
    assert not differ, f"params or state differ after steps {differ}"


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_a_warm_step_waits_for_the_card_nowhere(card, dataset, name):
    loop = new_loop(settings(name, dataset), dataset, card)
    params, opt_state = loop.init_state(0)
    batches = [loop.pipeline.next().to(card) for _ in range(2)]
    opt_state, _ = loop.eager_step(params, opt_state, batches[0],
                                   loop.draw(batches[0]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt_state, loss = loop.eager_step(params, opt_state, batches[1],
                                          loop.draw(batches[1]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(loss).item()


@pytest.mark.gpu
def test_no_producer_stream_is_the_capture_stream(card):
    """The producers' copy streams come from the default-priority pool,
    which hands out its 32 streams in turn; none is ever the stream that
    warms up and captures the step, whose work a copy would join."""
    side = engine.StepGraphs._side_stream(card)
    assert side == engine.StepGraphs._side_stream(card)
    producers = {torch.cuda.Stream(card).cuda_stream for _ in range(64)}
    assert side.cuda_stream not in producers


@pytest.mark.gpu
def test_a_resume_mid_replay_equals_the_whole_run(card, dataset, tmp_path):
    half = RESUME_STEPS // 2
    cfg = settings("gcn_block", dataset, save_every_n=half)
    loop = new_loop(cfg, dataset, card, prefetch=True)
    whole = loop.fit(max_iterations=RESUME_STEPS,
                     checkpoint_path=str(tmp_path / "a"))
    new_loop(cfg, dataset, card, prefetch=True).fit(
        max_iterations=half, checkpoint_path=str(tmp_path / "b"))
    resumed = new_loop(cfg, dataset, card, prefetch=True)
    tail = resumed.resume(str(tmp_path / "b"), max_iterations=RESUME_STEPS)
    assert [s["graph"] for s in whole.steps[half:]] == ["replay"] * half
    assert [s["graph"] for s in tail.steps][:3] == ["eager", "eager",
                                                  "capture"]
    assert [s["loss"] for s in whole.steps[half:]] \
        == [s["loss"] for s in tail.steps]
    for a, b in zip(tree_leaves((whole.params, whole.opt_state)),
                    tree_leaves((tail.params, tail.opt_state))):
        assert torch.equal(a, b)
