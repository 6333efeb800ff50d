"""The training window: ``TrainLoop.fit`` as ``train.py`` runs it.

Set-up builds the one loop (model, optimizer, prefetching pipelines with
their producer threads) on the seeded graph and weights, drives it through
its first ``CHECKED_STEPS`` steps by ``fit`` itself (the window's call and
feed), then hands the same loop, params and state to the window:
``fit(max_seconds=...)`` with no validation check. The rate is the
triples the window's steps trained over its host-clock seconds, a
synchronize at both ends. Two runs of ``CHECKED_STEPS`` steps are kept for
the comparison: the first steps of set-up, from the seeded weights, and
the window's own from its call ``WINDOW_CHECK_AT``, from the program's
state there; each keeps its batches and device draws, the state before
it, the optimizer's moment after its first step and the params after its
last, on the host. A window that closes before its
checked steps is followed, after the close, by the steps it lacks. Once
the window has closed and the program's state is freed, the reference
follows both runs from their start; ``compare`` says what is compared.
"""
from __future__ import annotations

import statistics
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .. import weights
from ..harness import (Outcome, Run, limit_entry, now, peak_bytes,
                       reset_peak, sync)
from ..reference import rgcn as ref
from ..trace import Trace, discard_session
from .common import (dataset, free_device, leaf_norm_gaps, leaves,
                     moving_leaves, port_config, quarters_line,
                     set_up_line)

CHECKED_STEPS = 3
# The window's checked steps start at its call WINDOW_CHECK_AT: past its
# first steps, inside its first seconds on the card.
WINDOW_CHECK_AT = 32
# The traced run records SLICE_STEPS steps at each of these fractions of
# the window.
SLICE_AT = (0.2, 0.4, 0.6, 0.8)
SLICE_STEPS = 8


def to_host(tree):
    """A copy of a nested dict / list of tensors in host memory."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


class CheckedSteps:
    """Wraps a loop's ``draw`` and ``train_step`` and keeps, from the
    call at index ``at`` on, ``n`` steps: each step's batch, device draws
    and loss, the params and optimizer state before the first, the
    optimizer's first moment after it and the params after the last, all
    copied to the host."""

    def __init__(self, loop, at: int, n: int):
        self.loop, self.at, self.n = loop, at, n
        self.calls = 0
        self.steps: list = []
        self.losses: list = []
        self.before = self.mu_after_first = self.params_after = None
        self._draws = None
        self._draw, self._train_step = loop.draw, loop.train_step
        loop.draw, loop.train_step = self.draw, self.train_step

    @property
    def done(self) -> bool:
        return len(self.steps) == self.n

    def draw(self, batch):
        self._draws = self._draw(batch)
        return self._draws

    def train_step(self, params, opt_state, batch):
        k = self.calls
        self.calls += 1
        if k == self.at:
            self.before = (to_host(params), to_host(opt_state))
        out = self._train_step(params, opt_state, batch)
        if self.at <= k < self.at + self.n:
            neg_values, corrupt_object = self._draws.negatives
            self.steps.append(to_host({
                "triples": batch.triples, "neg_values": neg_values,
                "corrupt_object": corrupt_object,
                "keep_masks": list(self._draws.keep_masks)}))
            self.steps[-1]["edge_ids"] = np.array(batch.edge_ids, copy=True)
            self.losses.append(out[1].detach().clone())
            if k == self.at:
                self.mu_after_first = to_host(out[0]["mu"])
            if k == self.at + self.n - 1:
                self.params_after = to_host(params)
        return out

    def close(self) -> None:
        del self.loop.draw, self.loop.train_step

    def taken(self, b1: float, device) -> dict:
        """What the program did, on ``device``: the steps' losses, the
        first step's gradient as Adam got it ((mu after - b1 mu before) /
        (1 - b1)) and the params after the last step, by leaf."""
        mu0 = leaves(self.before[1]["mu"])
        return {"losses": [float(x) for x in self.losses],
                "first_grads": {k: ((m - b1 * mu0[k]) / (1 - b1)).to(device)
                                for k, m in leaves(
                                    self.mu_after_first).items()},
                "params": {k: p.to(device) for k, p in leaves(
                    self.params_after).items()}}


def timed_steps(loop, ends: list, trace: Optional[Trace]) -> None:
    """Notes the host clock at the end of every step (as the host queued
    it) and, traced, steps the profiler's slices with the step's graph as
    its tag."""
    inner = loop.train_step

    def train_step(params, opt_state, batch):
        out = inner(params, opt_state, batch)
        if trace is not None:
            trace.step(batch.graph)
        ends.append(now())
        return out
    loop.train_step = train_step


def input_checks(step: dict, train: torch.Tensor, n_vertices: int,
                 n_relations: int, n_positives: int, n_message: int,
                 keep: float) -> int:
    """How many of the checks on what the reference takes from the run
    fail: the positives are train triples and the padding rows zero; the
    message edges are distinct train ids, as many as the split keeps; the
    corrupted entities lie in [0, V) and the coins and keep-masks fall
    at their probabilities (a fair coin, ``keep``) within 20 standard
    deviations."""
    bad = 0
    step = {k: v if k == "edge_ids" else to_device(v, train.device)
            for k, v in step.items()}
    t = step["triples"].long()
    def key(x):
        x = x.long()
        return (x[:, 0] * n_relations + x[:, 1]) * n_vertices + x[:, 2]
    known = torch.sort(key(train)).values
    pos = key(t[:n_positives])
    at = torch.searchsorted(known, pos).clamp(max=known.numel() - 1)
    bad += int(not bool((known[at] == pos).all()))
    bad += int(bool((t[n_positives:] != 0).any()))
    ids = step["edge_ids"]
    bad += int(len(ids) != n_message or len(np.unique(ids)) != len(ids)
               or ids.min() < 0 or ids.max() >= train.shape[0])
    v = step["neg_values"][:n_positives]
    bad += int(bool((v < 0).any() or (v >= n_vertices).any()))
    coin = step["corrupt_object"][:n_positives].float()
    bad += int(abs(coin.mean().item() - 0.5)
               > 20 * (0.25 / coin.numel()) ** 0.5)
    for m in step["keep_masks"]:
        share = m.float().mean().item()
        bad += int(abs(share - keep)
                   > 20 * (keep * (1 - keep) / m.numel()) ** 0.5)
    return bad


def run(r: Run) -> Outcome:
    from relationprediction_torch.models.build import build_model
    from relationprediction_torch.training.engine import TrainLoop

    marks = [("imports", now())]
    spec = ref.spec_from_settings(r.settings)
    traffic = r.traffic
    ds = dataset(traffic, r.seed)
    marks.append(("graph", now()))
    v, n_rel = ds.n_entities, ds.n_relations
    cfg = port_config(r.settings).with_counts(v, n_rel, len(ds.train))
    model = build_model(cfg, r.device)
    params = weights.make_params(spec, v, n_rel, r.seed, r.device)
    loop = TrainLoop(model, cfg, ds, seed=r.seed, log=lambda _: None,
                     prefetch=True,
                     prefetch_threads=traffic["prefetch_threads"],
                     negative_mode=traffic["negative_mode"],
                     sampler=traffic["sampler"])
    marks.append(("model, weights, loop", now()))
    if loop.loss_kind != "factored":
        raise ValueError(f"the reference follows the factored binomial "
                         f"loss, not {loop.loss_kind!r}")
    opt_state = loop.optimizer.init(params)
    first = CheckedSteps(loop, 0, CHECKED_STEPS)
    result = loop.fit(params, opt_state, max_iterations=CHECKED_STEPS)
    first.close()
    opt_state, done = result.opt_state, CHECKED_STEPS
    marks.append(("checked steps", now()))
    if r.trace:
        def one_step():
            nonlocal opt_state
            opt_state = loop.fit(params, opt_state, start_iteration=done,
                                 max_iterations=done + 1).opt_state
        discard_session(one_step)
        done += 1
    sync(r.device)
    setup_s = now() - r.t_start
    marks.append(("end", now()))
    r.log(set_up_line(r.t_start, marks))

    peak_setup = peak_bytes(r.device)
    reset_peak(r.device)
    trace = Trace(r.seconds, SLICE_AT, SLICE_STEPS, now) if r.trace \
        else None
    ends: list = []
    window = CheckedSteps(loop, WINDOW_CHECK_AT, CHECKED_STEPS)
    timed_steps(loop, ends, trace)
    if trace is not None:
        trace.__enter__()
    try:
        t0 = now()
        result = loop.fit(params, opt_state, start_iteration=done,
                          max_seconds=r.seconds)
        sync(r.device)
        window_s = now() - t0
    finally:
        if trace is not None:
            trace.__exit__(None, None, None)
    peak_window = peak_bytes(r.device)
    r.log(quarters_line(t0, ends, window_s))
    steps = result.steps
    if not window.done:
        r.log(f"the window closed after {len(steps)} steps, before its "
              f"checked steps: they follow it, untimed")
        loop.train_step = window.train_step
        more = window.at + window.n - window.calls
        loop.fit(params, result.opt_state,
                 start_iteration=done + len(steps),
                 max_iterations=done + len(steps) + more)
    window.close()
    n_positives = loop.pipeline.n_positives
    readings = SimpleNamespace(
        kind="train", steps=steps, window_s=window_s,
        shape={"variant": spec.variant, "d": spec.d, "dr": spec.dr,
               "n_bases": spec.n_blocks, "n_blocks": spec.n_blocks,
               "n_layers": spec.n_layers},
        n_vertices=v, n_message_edges=loop.pipeline.split_size,
        n_positives=n_positives, rate=spec.rate,
        peak_window_bytes=peak_window, trace=trace)
    failed = sum(1 for s in steps if not np.isfinite(s["loss"]))
    train_triples = torch.as_tensor(ds.train, device=r.device)
    n_message = loop.pipeline.split_size
    del loop, model, params, opt_state, result
    free_device()

    # -- the reference, once the window has closed ---------------------
    ref.exact_float32()
    numbers = {}
    for checked in (first, window):
        numbers.update((prefix(checked.at) + k, c) for k, c in check(
            checked, r, spec, train_triples, n_positives).items())
    bad_inputs = sum(input_checks(s, train_triples, v, n_rel, n_positives,
                                  n_message, spec.keep)
                     for s in first.steps + window.steps)
    compared = dict(limit_entry(k, c["value"], r.limits[k])
                    for k, c in numbers.items() if k in r.limits)
    compared.update([limit_entry("inputs_off", bad_inputs, 0)])
    return Outcome(
        end_to_end={"train_triples_per_s": len(steps) * n_positives
                    / window_s, "setup_s": setup_s},
        attempted=len(steps), failed=failed, compared=compared,
        memory_peak_bytes=max(peak_setup, peak_window), readings=readings,
        trace=trace)


def prefix(at: int) -> str:
    """The prefix of the numbers of the checked steps from call ``at``:
    none for set-up's first steps, ``window_`` for the window's."""
    return "" if at == 0 else "window_"


def check(checked: CheckedSteps, r: Run, spec, train_triples,
          n_positives: int) -> dict:
    """The numbers of ``compare`` for one run of checked steps, the
    reference following it from the same start; what the reference was
    given, and both sides' results, kept in ``r.kept`` under the run's
    first step (0 for set-up's)."""
    device = train_triples.device
    params0, state = (to_device(x, device) for x in checked.before)
    ref_steps = [{
        "edges": train_triples[torch.as_tensor(s["edge_ids"],
                                               device=device).long()],
        "positives": s["triples"][:n_positives].to(device),
        "neg_values": s["neg_values"][:n_positives].to(device),
        "corrupt_object": s["corrupt_object"][:n_positives].to(device),
        "keep_masks": [m.to(device) for m in s["keep_masks"]]}
        for s in checked.steps]
    n_vertices = int(params0["input_transform"]["W"].shape[0])
    want = ref.train_steps(params0, ref_steps, spec, n_vertices, state=state)
    got = checked.taken(spec.b1, device)
    r.kept[checked.at] = dict(params0=params0, state=state, steps=ref_steps,
                              spec=spec, n_vertices=n_vertices, want=want,
                              got=got)
    return compare(got, want, params0)


def compare(got: dict, want: dict, params0) -> dict:
    """The numbers compared, of ``got`` against ``want`` (each: the steps'
    ``losses``, the first clipped gradient and the params after the steps,
    by leaf), each as ``{"value"}``: the worst step's relative loss gap
    (``loss_gap``); the median leaf's gap of first-gradient norms
    (``grad_gap``); the worst leaf's gap of the params' change over the
    steps (``change_gap``; leaves whose reference gradient is nought to
    rounding left out). The first gradient is compared at the median leaf:
    its worst leaf is the basis layer's 1,185 coefficients of layer 0 on
    some seeds, where a ReLU at a hub vertex that falls on the other side
    of 0 in another sum order moves them by up to 7e-5 (PERF.md section
    2). A cell compares those of its numbers that its file gives a
    limit."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    keep = moving_leaves(want["first_grads"])
    start = leaves(params0)
    got_change = {k: p - start[k] for k, p in got["params"].items()}
    want_change = {k: p - start[k] for k, p in want["params"].items()}
    values = {
        "loss_gap": loss_gap,
        "grad_gap": statistics.median(leaf_norm_gaps(
            got["first_grads"], want["first_grads"], keep)),
        "change_gap": max(leaf_norm_gaps(got_change, want_change, keep))}
    return {k: {"value": float(x) if x == x else float("inf")}
            for k, x in values.items()}
