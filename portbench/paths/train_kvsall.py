"""The 1-N training window: ``TrainLoop.fit`` of CompGCN + ConvE as
``train.py`` runs it.

As ``paths/train.py``: set-up builds the one loop (model, optimizer, the
prefetching producer of the 1-N batches) on the seeded graph and weights,
drives it through its first ``CHECKED_STEPS`` steps by ``fit`` itself,
then hands the same loop, params and state to the window,
``fit(max_seconds=...)`` with no validation check. The rate is the
queries the window's steps trained over its host-clock seconds, a
synchronize at both ends. Two runs of ``CHECKED_STEPS`` steps are kept
for the comparison: set-up's first steps from the seeded weights, and the
window's from its call ``WINDOW_CHECK_AT``, from the program's state
there; each keeps its queries, label rows and keep-masks, the state before
it, the params before each of its steps, the optimizer's first moment after
its first step and the params after its last, on the host. Once the window
has closed and the program's state is freed, the reference
(``portbench/reference/compgcn.py``) follows both runs from their start
over the whole train graph; ``train.compare`` says what is compared, but
each step's loss is the reference's from the params the program took that
step from (``ref.step_losses``): Adam's first steps move every element
by about lr whatever its gradient's size, so where two f32 evaluations of
the first gradient differ in a ReLU that lands within rounding of 0, a
reference that follows from the start parts from the program's params and
losses by more than either's rounding (PERF.md section 2); the params'
change over the steps is still compared against the reference's own.
``inputs_off`` counts the checks of what the reference takes from the run
that fail (``input_checks``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import bounds_compgcn, weights_compgcn
from ..harness import (Outcome, Run, limit_entry, now, peak_bytes,
                       reset_peak, sync)
from ..reference import compgcn as ref
from ..reference.rgcn import leaves
from ..trace import Trace, discard_session
from .common import dataset, free_device, port_config, quarters_line, \
    set_up_line
from .train import (CHECKED_STEPS, SLICE_AT, SLICE_STEPS, WINDOW_CHECK_AT,
                    CheckedSteps, compare, prefix, timed_steps, to_device,
                    to_host)


class CheckedQuerySteps(CheckedSteps):
    """``CheckedSteps`` of a 1-N loop: each kept step holds its queries,
    label rows and keep-masks, and ``params_before`` the params each kept
    step was taken from."""

    def __init__(self, loop, at: int, n: int):
        super().__init__(loop, at, n)
        self.params_before: list = []

    def train_step(self, params, opt_state, batch):
        k = self.calls
        self.calls += 1
        if k == self.at:
            self.before = (to_host(params), to_host(opt_state))
        if self.at <= k < self.at + self.n:
            self.params_before.append(self.before[0] if k == self.at
                                      else to_host(params))
        out = self._train_step(params, opt_state, batch)
        if self.at <= k < self.at + self.n:
            self.steps.append(to_host({
                "queries": batch.triples, "labels": batch.labels,
                "mask": batch.mask,
                "keep_masks": list(self._draws.keep_masks)}))
            self.losses.append(out[1].detach().clone())
            if k == self.at:
                self.mu_after_first = to_host(out[0]["mu"])
            if k == self.at + self.n - 1:
                self.params_after = to_host(params)
        return out


def label_rows(train: torch.Tensor, queries: torch.Tensor, n_vertices: int,
               n_relations: int) -> torch.Tensor:
    """[n, V] bool: the entities that complete each query (s, r) in the
    train graph, (s, r, o) for r < R and (o, r - R, s) above, worked out
    again from the triples."""
    t = train.long()
    q = queries.long()
    out = torch.zeros(q.shape[0], n_vertices, dtype=torch.bool,
                      device=train.device)
    for i, (s, r) in enumerate(q[:, :2].tolist()):
        if r < n_relations:
            hit = t[(t[:, 0] == s) & (t[:, 1] == r), 2]
        else:
            hit = t[(t[:, 2] == s) & (t[:, 1] == r - n_relations), 0]
        out[i, hit] = True
    return out


def input_checks(step: dict, train: torch.Tensor, n_vertices: int,
                 n_relations: int, spec) -> int:
    """How many of the checks on what the reference takes from the run
    fail: the queries' entities lie in [0, V) and relations in [0, 2R), a
    full batch with a mask of ones; the label rows are the train graph's
    own; each keep-mask keeps its share (1 - drop) within 20 standard
    deviations."""
    device = train.device
    q = step["queries"].to(device).long()
    bad = int(q.shape[0] != spec.batch
              or bool((q[:, 0] < 0).any() or (q[:, 0] >= n_vertices).any()
                      or (q[:, 1] < 0).any()
                      or (q[:, 1] >= 2 * n_relations).any()))
    bad += int(not bool((step["mask"] == 1).all()))
    if not bad:
        want = label_rows(train, q, n_vertices, n_relations)
        bad += int(not torch.equal(want, step["labels"].to(device)))
    drops = (spec.layer_drop, spec.layer_drop, spec.hidden_drop,
             spec.feature_drop, spec.decoder_drop)
    for m, drop in zip(step["keep_masks"], drops):
        keep = 1.0 - drop
        share = m.float().mean().item()
        bad += int(abs(share - keep)
                   > 20 * (keep * (1 - keep) / m.numel()) ** 0.5)
    return bad + int(len(step["keep_masks"]) != len(drops))


def run(r: Run) -> Outcome:
    from relationprediction_torch.models.build import build_model
    from relationprediction_torch.training.engine import TrainLoop

    marks = [("imports", now())]
    spec = ref.spec_from_settings(r.settings)
    traffic = r.traffic
    v, n_rel = traffic["n_entities"], traffic["n_relations"]
    cfg = port_config(r.settings).with_counts(v, n_rel, traffic["n_train"])
    model = build_model(cfg, r.device)
    if getattr(model, "objective", None) != "kvsall":
        raise ValueError("this path trains a 1-N (KvsAll) model")
    ds = dataset(traffic, r.seed)
    marks.append(("graph", now()))
    params = weights_compgcn.make_params(spec, v, n_rel, r.seed, r.device)
    loop = TrainLoop(model, cfg, ds, seed=r.seed, log=lambda _: None,
                     prefetch=True,
                     prefetch_threads=traffic["prefetch_threads"])
    marks.append(("model, weights, loop", now()))
    opt_state = loop.optimizer.init(params)
    first = CheckedQuerySteps(loop, 0, CHECKED_STEPS)
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
    window = CheckedQuerySteps(loop, WINDOW_CHECK_AT, CHECKED_STEPS)
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
    r.log(f"graph counts: {loop.graph_counts}")
    if not window.done:
        r.log(f"the window closed after {len(steps)} steps, before its "
              f"checked steps: they follow it, untimed")
        loop.train_step = window.train_step
        more = window.at + window.n - window.calls
        loop.fit(params, result.opt_state,
                 start_iteration=done + len(steps),
                 max_iterations=done + len(steps) + more)
    window.close()
    c = cfg.compgcn
    shape = {"model": "compgcn", "variant": "compgcn", "d_in": spec.d_in,
             "d": spec.d, "n_vertices": v, "n_relations": n_rel,
             "kernel": c.kernel_size, "n_filters": c.n_filters,
             "conv_height": c.conv_height, "conv_width": c.conv_width,
             "aggregate_launches": bounds_compgcn.step_launches(
                 loop.train_graph, spec.d_in, spec.d)}
    n_queries = loop.pipeline.n_positives
    readings = SimpleNamespace(
        kind="train", steps=steps, window_s=window_s, shape=shape,
        n_vertices=v, n_positives=n_queries,
        graph_counts=dict(loop.graph_counts),
        peak_window_bytes=peak_window, trace=trace)
    failed = sum(1 for s in steps if not np.isfinite(s["loss"]))
    train_triples = torch.as_tensor(ds.train, device=r.device)
    del loop, model, params, opt_state, result
    free_device()

    # -- the reference, once the window has closed ---------------------
    numbers = {}
    for checked in (first, window):
        numbers.update((prefix(checked.at) + k, x) for k, x in check(
            checked, r, spec, train_triples, n_rel).items())
    bad_inputs = sum(input_checks(s, train_triples, v, n_rel, spec)
                     for s in first.steps + window.steps)
    compared = dict(limit_entry(k, x["value"], r.limits[k])
                    for k, x in numbers.items() if k in r.limits)
    compared.update([limit_entry("inputs_off", bad_inputs, 0)])
    return Outcome(
        end_to_end={"train_triples_per_s": len(steps) * n_queries
                    / window_s, "setup_s": setup_s},
        attempted=len(steps), failed=failed, compared=compared,
        memory_peak_bytes=max(peak_setup, peak_window), readings=readings,
        trace=trace)


def check(checked: CheckedQuerySteps, r: Run, spec, train_triples,
          n_relations: int) -> dict:
    """The numbers of ``compare`` for one run of checked steps, the
    reference following it from the same start on the whole train graph,
    and each step's loss the reference's from the params the program took
    it from; what the reference was given and both sides' results are kept
    in ``r.kept`` under the run's first step (0 for set-up's)."""
    device = train_triples.device
    params0, state = (to_device(x, device) for x in checked.before)
    ref_steps = [to_device(s, device) for s in checked.steps]
    want = ref.train_steps(params0, ref_steps, spec, train_triples,
                           n_relations, state=state)
    before = [to_device(p, device) for p in checked.params_before]
    want["losses"] = ref.step_losses(before, ref_steps, spec, train_triples,
                                     n_relations)
    got = checked.taken(spec.b1, device)
    r.kept[checked.at] = dict(params0=params0, state=state, steps=ref_steps,
                              params_before=before, spec=spec,
                              train=train_triples, n_relations=n_relations,
                              want=want, got=got)
    return compare(got, want, params0)


def readings_of(kept: dict, tf32: bool = False) -> dict:
    """The reference's own run of ``kept``'s steps, with TF32 products
    where ``tf32`` (the control), each step's loss from the params the
    program took it from."""
    out = ref.train_steps(kept["params0"], kept["steps"], kept["spec"],
                          kept["train"], kept["n_relations"], tf32=tf32,
                          state=kept["state"])
    out["losses"] = ref.step_losses(kept["params_before"], kept["steps"],
                                    kept["spec"], kept["train"],
                                    kept["n_relations"], tf32=tf32)
    return out


def study_readings(kept: dict) -> dict:
    """The numbers of ``compare`` with the control and each fault put in
    the program's place, from the same start: TF32 in cuBLAS and cuDNN;
    half of each batch's queries left out (their label rows and masks
    with them); a step that returns its state unchanged."""
    want, params0 = kept["want"], kept["params0"]
    numbers = {"control": compare(readings_of(kept, tf32=True), want,
                                  params0)}
    half = dict(kept, steps=[half_batch(s) for s in kept["steps"]])
    numbers["half_batch"] = compare(readings_of(half), want, params0)
    unchanged = {"losses": want["losses"],
                 "first_grads": {k: torch.zeros_like(g)
                                 for k, g in want["first_grads"].items()},
                 "params": leaves(params0)}
    numbers["unchanged_state"] = compare(unchanged, want, params0)
    return numbers


def half_batch(step: dict) -> dict:
    """The step with the first half of its queries alone."""
    n = step["queries"].shape[0] // 2
    masks = list(step["keep_masks"])
    masks[3], masks[4] = masks[3][:n], masks[4][:n]
    return dict(step, queries=step["queries"][:n], labels=step["labels"][:n],
                mask=step["mask"][:n], keep_masks=masks)
