"""Training engine: host batches and the fit loop.

Counterpart of ``relationprediction_tpu/training/engine.py`` for the path
``TrainLoop`` takes by default with a DistMult decoder: device negatives,
the binomial protocol, the factored loss (``engine.py:452-466``). Each step

  1. on the host: samples ``GraphBatchSize`` edges by neighbourhood
     expansion, keeps ``GraphSplitSize`` of them as the message graph, lays
     it out (four CSRs, graph.py) and ships it with the padded positives;
  2. on the device: draws the corruptions and the dropout keep-masks from
     the loop's ``torch.Generator``, encodes in train mode, takes the
     factored binomial loss and its gradients (the aggregation kernels'
     twin passes inside), clips and applies Adam in place.

Losses are read on the host only at the reporting cadence of the reference
(iteration 1, then every ``ReportTrainLossEvery`` at i % n == 1). The JAX
package's prefetch threads, its K-step ``lax.scan`` dispatch (a TPU
transport device, not carried over), validation with early stopping and
checkpoint saving come with ROADMAP.md Queue 1 item 3; the other negative
protocols with item 5.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import RunConfig
from ..data.dataset import KGDataset
from ..graph import GraphBatch
from ..models.build import RGCNModel
from ..observability import StepTimer
from ..ops import staircase2
from ..params import tree_leaves, tree_unflatten
from ..sampling import (AdjacencyIndex, graph_split,
                        sample_edge_neighborhood_fast, sample_uniform_edges)
from .device_sampling import device_negative_parts
from .optimizers import apply_updates, build_optimizer


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class TrainBatch(NamedTuple):
    graph: GraphBatch
    triples: torch.Tensor  # [N_pad, 3] int32 positives, zero rows as padding
    mask: torch.Tensor     # [N_pad] float32, 1 for a real positive


class BatchPipeline:
    """Host-side batch construction (``engine.py:64-204``, the reference's
    t_func, ``train.py:205-247``) for device negatives: the sampled
    subgraph's split as the message graph, and the sampled edges as the
    positives, padded to a multiple of 8 with a mask.

    The same ``rng`` state gives the JAX package's graphs and positives.
    """

    def __init__(self, model: RGCNModel, config: RunConfig,
                 dataset: KGDataset, rng: np.random.Generator,
                 sampler: str = "neighborhood"):
        if sampler not in ("neighborhood", "uniform"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.model = model
        self.config = config
        self.train = np.asarray(dataset.train, dtype=np.int32)
        self.rng = rng
        self.sampler = sampler
        t = config.training
        n_train = len(self.train)
        self.graph_batch_size = min(t.graph_batch_size or n_train, n_train)
        self.split_size = int(t.graph_split_size * self.graph_batch_size)
        self.adj = AdjacencyIndex(self.train, config.entity_count)
        self.positives_pad = _round_up(self.graph_batch_size, 8)

    def sample_ids(self) -> tuple:
        """(batch edge ids, message-graph edge ids) into the train set."""
        if self.graph_batch_size >= len(self.train):
            batch_ids = np.arange(len(self.train), dtype=np.int32)
        elif self.sampler == "neighborhood":
            batch_ids = sample_edge_neighborhood_fast(
                self.adj, self.graph_batch_size, self.rng)
        else:
            batch_ids = sample_uniform_edges(
                len(self.train), self.graph_batch_size, self.rng)
        split_ids = graph_split(batch_ids,
                                self.config.training.graph_split_size,
                                self.rng)
        return batch_ids, split_ids

    def next(self) -> TrainBatch:
        batch_ids, split_ids = self.sample_ids()
        graph = self.model.make_graph(self.train[split_ids])
        positives = self.train[batch_ids]
        n = len(positives)
        xp = np.zeros((self.positives_pad, 3), dtype=np.int32)
        mp = np.zeros((self.positives_pad,), dtype=np.float32)
        xp[:n] = positives
        mp[:n] = 1.0
        device = self.model.device
        return TrainBatch(graph, torch.from_numpy(xp).to(device),
                          torch.from_numpy(mp).to(device))


def loss_and_grads(model: RGCNModel, params, batch: TrainBatch,
                   neg_values: torch.Tensor, corrupt_object: torch.Tensor,
                   keep_masks) -> tuple:
    """(loss, gradient tree) of the factored binomial loss for explicit
    draws. A leaf the loss does not reach (the GCN layers' unused bias)
    gets a zero gradient, as under ``jax.grad``."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        loss = model.loss_binomial_factored(
            params, batch.graph, batch.triples, batch.mask, neg_values,
            corrupt_object, deterministic=False, keep_masks=keep_masks)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


@dataclass
class FitResult:
    params: dict
    opt_state: dict
    iterations: int
    last_loss: float
    # One dict per step: iteration, loss, batch_ms (host clock: sampling,
    # split, layouts, host to device, after the previous step has ended),
    # step_ms (CUDA events around the
    # device step; None on the CPU), and the aggregation kernels' forward
    # and twin launches in the step (staircase2.launch_counts).
    steps: list = field(default_factory=list)


class TrainLoop:
    """``fit`` with the reference's loss-reporting cadence
    (``shared/algorithms.py:82-116``)."""

    def __init__(self, model: RGCNModel, config: RunConfig,
                 dataset: KGDataset, *,
                 sampler: str = "neighborhood",
                 seed: int = 0,
                 log: Callable[[str], None] = print):
        if not getattr(model.decoder, "factorizable", False):
            raise NotImplementedError(
                f"decoder {model.decoder.name!r} needs the tiled loss, not "
                f"ported yet (ROADMAP.md Queue 1 item 5)")
        self.model = model
        self.config = config
        self.log = log
        self.host_rng = np.random.default_rng(seed)
        self.pipeline = BatchPipeline(model, config, dataset, self.host_rng,
                                      sampler)
        self.optimizer = build_optimizer(config.optimizer)
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(seed)
        self.timer = StepTimer()

    def init_state(self, seed: int = 0) -> tuple:
        params = self.model.init_params(
            torch.Generator().manual_seed(seed))
        return params, self.optimizer.init(params)

    def draw(self, batch: TrainBatch) -> tuple:
        """The step's random draws on the device: corruptions
        (``device_negative_parts``) and one dropout keep-mask per layer."""
        values, co = device_negative_parts(
            batch.triples, self.config.training.negative_sample_rate,
            self.config.entity_count, self.generator)
        return values, co, self.model.draw_keep_masks(self.generator)

    def train_step(self, params, opt_state, batch: TrainBatch) -> tuple:
        """One step (``engine.py:452-466``); updates ``params`` in place.
        Returns (opt_state, loss as a 0-d tensor on the device)."""
        values, co, masks = self.draw(batch)
        loss, grads = loss_and_grads(self.model, params, batch, values, co,
                                     masks)
        updates, opt_state = self.optimizer.update(grads, opt_state)
        apply_updates(params, updates)
        return opt_state, loss

    def fit(self, params=None, opt_state=None, *,
            max_iterations: Optional[int] = None) -> FitResult:
        if params is None:
            params, opt_state = self.init_state()
        max_iter = max_iterations if max_iterations is not None \
            else self.config.optimizer.max_iterations
        if max_iter is None:
            raise NotImplementedError(
                "training until early stopping is not ported yet "
                "(ROADMAP.md Queue 1 item 3); give max_iterations")
        report_every = self.config.optimizer.report_train_loss_every
        on_card = self.model.device.type == "cuda"
        records, pending = [], []
        cumulative_loss, loss = 0.0, float("nan")

        def process_pending():
            nonlocal cumulative_loss, loss
            for rec, loss_dev, events in pending:
                it_ = rec["iteration"]
                loss = rec["loss"] = float(loss_dev)
                if events is not None:
                    events[1].synchronize()
                    rec["step_ms"] = events[0].elapsed_time(events[1])
                cumulative_loss += loss
                if it_ == 1:
                    cumulative_loss = 0.0
                    self.log(f"Initial loss: {loss}")
                elif report_every and it_ % report_every == 1:
                    avg = cumulative_loss / float(report_every)
                    cumulative_loss = 0.0
                    s = self.timer.summary()
                    self.log(f"Average train loss for iteration "
                             f"{it_ - report_every}-{it_ - 1}: {avg} "
                             f"({s['steps_per_sec']} steps/s, "
                             f"{s['edges_per_sec']} edges/s)")
            pending.clear()

        i = 0
        while i < max_iter:
            i += 1
            with self.timer.step(edges=self.pipeline.split_size):
                if on_card:
                    # The batch's copies to the card wait for the queued
                    # step; waiting here keeps that out of batch_ms.
                    torch.cuda.synchronize(self.model.device)
                t0 = time.perf_counter()
                batch = self.pipeline.next()
                batch_ms = (time.perf_counter() - t0) * 1e3
                fwd0, twin0 = staircase2.launch_counts()
                events = None
                if on_card:
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                opt_state, loss_dev = self.train_step(params, opt_state,
                                                      batch)
                if on_card:
                    events[1].record()
            fwd1, twin1 = staircase2.launch_counts()
            rec = {"iteration": i, "batch_ms": batch_ms, "step_ms": None,
                   "launches": fwd1 - fwd0, "twin_launches": twin1 - twin0}
            records.append(rec)
            pending.append((rec, loss_dev, events))
            if i == 1 or (report_every and i % report_every == 1):
                process_pending()
        process_pending()
        return FitResult(params=params, opt_state=opt_state, iterations=i,
                         last_loss=loss, steps=records)
