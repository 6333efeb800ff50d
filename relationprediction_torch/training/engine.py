"""Training engine: host batches, their prefetch, and the fit loop.

Counterpart of ``relationprediction_tpu/training/engine.py`` on one device,
with every training objective of the JAX package, chosen by its rule
(``engine.py:391-410``, ``loss_kind``): with a factorizable decoder
(DistMult, ComplEx) and device negatives, the factored binomial loss, the
split protocol's ``loss_structured`` or the shared pool's
``loss_shared_negatives`` (``--negative-mode binomial|split|shared``);
otherwise (the MLP decoder, or ``device_negatives=False``) the tiled loss
on the binomial protocol's (rate+1)-tiled batch, drawn on the device or
tiled on the host. Each step

  1. on the host (``BatchPipeline``, on ``prefetch_threads`` producer
     threads by default, ``_Prefetcher``): samples ``GraphBatchSize`` edges
     by neighbourhood expansion and keeps ``GraphSplitSize`` of them as the
     message graph, laid out as four CSRs (graph.py), or, for a model
     without a graph, takes a ``BatchSize`` minibatch (all of the train set
     when unset); pads the positives with a mask, or with
     ``device_negatives=False`` tiles them with their corruptions and
     labels; in pinned host memory on the card's machine; a producer
     copies its batches to the card on its own CUDA stream;
  2. on the device: draws the corruptions (unless the host tiled them),
     the dropout keep-masks and the encoder's other noise (random input,
     the dropover choice, the variational noise, for a configuration that
     uses them) from the loop's ``torch.Generator``, encodes in train
     mode, takes the loss and its gradients (the aggregation kernels' twin
     passes inside), clips and applies the optimizer in place. On one
     card the draws stay op by op and the rest of the step is replayed as
     one CUDA graph from a signature's third step on (``StepGraphs``); no
     operation of the step reads a device value on the host.

A model trained against every entity at once (``CompGCNModel``, the
port's own) takes the 'kvsall' objective: one producer's
``QueryPipeline`` makes its 1-N batches (queries and label rows), and the
loop's whole train graph, built once on the device, is every step's
message graph; the step replays as one CUDA graph like the others.

The stored-message variant (``RGCNModel.has_state``) trains, as in the
JAX package (``engine.py:91``, ``:520-535``), on host-tiled batches with
the tiled loss (``loss_stateful``); its batches carry the message graph's
edge ids to the device, and the loop holds the per-edge caches and steps
them (``TrainLoop.cache_state``). Caches are not checkpointed, in the JAX
package neither: a resumed run starts from zero caches.

Losses are read on the host only at the reporting cadence of the reference
(iteration 1, then every ``ReportTrainLossEvery`` at i % n == 1). The
validation score is taken every ``CheckEvery`` iterations, with early
stopping after the burn-in, and a checkpoint is written at each check that
did not stop (``shared/algorithms.py:61-161``); ``resume`` continues one.

With ``mesh`` (an ``EdgeMesh``, ``parallel/mesh.py``; one process a
rank) every rank runs the same seeded pipelines and keeps its block of
each batch: its shard of the message graph's edges, weighted over the
whole graph, and its rows of the padded positives
(``BatchPipeline(shard_multiple=, shard_rank=)``), and takes the sharded
step (the loss's all-reduces, backward, the mean of the gradients over
the ranks: ``sharded_loss_and_grads``; then the optimizer). Each
step's draws come from two generators seeded from (seed, step): the
corruptions of the rank's rows from one seeded with its rank too, the
keep-masks, the other encoder noise and the shared pool from one that is
the same on every rank (the JAX package's ``fold_in``s,
``mesh.py:111-117``), so that the ranks' self-loop terms and params
agree. Only rank 0 writes checkpoints and metric records; a mesh
checkpoint restores on one device and a one-device checkpoint resumes on
a mesh. The stored-message variant's step raises on a mesh, as in the
JAX package (``engine.py:335-337``).

With ``vertex_sharded`` (on a mesh; ``parallel/vertex_sharded.py``, the JAX
package's ``engine.py:311-416``) the entity table is row-sharded over the ranks
instead: each rank's pipeline (``VertexShardedBatchPipeline(shard_rank=)``)
lays out its shard of the destination-partitioned graph and its slice of a
factored batch (a factorizable decoder with device negatives) or of a
host-tiled one, with host-drawn corruptions; the step is
``VertexShardedEncoder``'s, whose keep-masks come from the rank's generator
('per_shard'). The params of ``fit`` are padded to the sharded layout
(one-device params are padded and the optimizer state reinitialised, with the
JAX package's log line), each rank keeps its rows of the table and its moments,
and checkpoints and ``FitResult`` hold the padded trees gathered from the
ranks, the JAX package's layout.
Not carried over from the JAX package: its K-step ``lax.scan`` dispatch
(a TPU transport device).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import RunConfig, require_single_card
from ..data.dataset import KGDataset
from ..graph import GraphBatch
from ..models.build import EncoderNoise, RGCNModel
from ..observability import MetricLogger, StepTimer, collect, span, spans_ms
from ..ops import add_launches, launch_counters, staircase2
from ..parallel.collectives import broadcast_value, pmean
from ..parallel.distributed import is_coordinator
from ..parallel.mesh import EdgeMesh, replicate, shard_batch
from ..params import map_tree, params_from_jax, params_to_numpy, \
    tree_leaves, tree_unflatten
from ..sampling import AdjacencyIndex, NegativeSampler, draw_subgraph
from . import checkpoint as ckpt_lib
from .device_sampling import (device_negative_entities_split,
                              device_negative_parts, device_negative_pool,
                              device_negative_sample)
from .optimizers import apply_updates, build_optimizer, opt_state_from_jax


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class TrainBatch(NamedTuple):
    graph: Optional[GraphBatch]  # None for a model without a graph
    # [N_pad, 3] int32 positives, zero rows as padding; host-tiled: the
    # positives and their corruptions, [(rate+1) N] padded to 128
    triples: torch.Tensor
    mask: torch.Tensor     # [N_pad] float32, 1 for a real row
    # Host int32 ids into the train set of the message graph's edges
    # (None without a graph); they stay on the host.
    edge_ids: Optional[np.ndarray] = None
    # [N_pad] float32 labels of a host-tiled batch, else None
    labels: Optional[torch.Tensor] = None
    # The same ids as an int64 [E] tensor that moves with the batch, for a
    # model with stored-message state (its caches' rows); else None
    message_edge_ids: Optional[torch.Tensor] = None
    # Host counts of the batch's work, where its producer keeps them (a
    # 1-N batch: its queries and the positives of its label rows)
    counts: Optional[dict] = None

    def to(self, device, non_blocking: bool = False) -> "TrainBatch":
        def move(t):
            return None if t is None \
                else t.to(device, non_blocking=non_blocking)
        graph = None if self.graph is None \
            else self.graph.to(device, non_blocking)
        return TrainBatch(graph, move(self.triples), move(self.mask),
                          self.edge_ids, move(self.labels),
                          move(self.message_edge_ids), self.counts)

    def pin_memory(self) -> "TrainBatch":
        def pin(t):
            return None if t is None else t.pin_memory()
        return TrainBatch(
            None if self.graph is None else self.graph.pin_memory(),
            self.triples.pin_memory(), self.mask.pin_memory(),
            self.edge_ids, pin(self.labels), pin(self.message_edge_ids),
            self.counts)

    def tensors(self) -> list:
        graph = [] if self.graph is None else self.graph.tensors()
        return graph + [self.triples, self.mask] + [
            t for t in (self.labels, self.message_edge_ids)
            if t is not None]


class BatchPipeline:
    """Host-side batch construction (``engine.py:74-204``, the reference's
    t_func, ``train.py:205-247``): the sampled subgraph's split as the
    message graph and the sampled edges as the positives, or a minibatch
    of positives for a model without a graph. With device negatives the
    positives are padded to a multiple of 8 with a mask
    (``_positives_batch``, ``engine.py:191-204``); with
    ``device_negatives=False`` ``NegativeSampler`` tiles them (rate+1)
    times with their corruptions, padded to a multiple of 128 with labels
    and a mask (``engine.py:149-179``). ``shard_multiple`` n pads them to
    multiples of lcm(8, n) and lcm(128, n) instead, so that n ranks take
    equal blocks (``engine.py:102``, ``:197``); ``shard_rank`` then keeps
    that rank's block of the rows (``mesh.shard_batch``) and builds only
    its shard of the message graph (``graph.build_graph_batch(shard=)``).

    The same ``rng`` state gives the JAX package's graphs, positives and
    host-tiled corruptions. The batch stays on the host, pinned when the
    model is on the card. A model with stored-message state always gets
    host-tiled batches (``engine.py:91``), with its message graph's edge
    ids as a tensor (``TrainBatch.message_edge_ids``).
    """

    def __init__(self, model: RGCNModel, config: RunConfig,
                 dataset: KGDataset, rng: np.random.Generator,
                 sampler: str = "neighborhood",
                 device_negatives: bool = True, shard_multiple: int = 1,
                 shard_rank: Optional[int] = None):
        if sampler not in ("neighborhood", "uniform"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.model = model
        self.config = config
        self.train = np.asarray(dataset.train, dtype=np.int32)
        self.rng = rng
        self.sampler = sampler
        self.pin = model.device.type == "cuda"
        t = config.training
        n_train = len(self.train)
        if model.needs_graph():
            self.graph_batch_size = min(t.graph_batch_size or n_train,
                                        n_train)
            self.split_size = int(t.graph_split_size * self.graph_batch_size)
            self.adj = AdjacencyIndex(self.train, config.entity_count)
            cap = self.graph_batch_size
        else:
            self.batch_size = min(config.optimizer.batch_size or n_train,
                                  n_train)
            self.split_size = 0
            cap = self.batch_size
        self.n_positives = cap
        n = max(1, int(shard_multiple))
        self.shard = None if shard_rank is None else (int(shard_rank), n)
        self.positives_pad = _round_up(cap, int(np.lcm(8, n)))
        self.device_negatives = device_negatives and not model.has_state
        rate = t.negative_sample_rate
        # The host-tiled batch's rows, padded as the JAX package pads them.
        self.triple_pad = _round_up(cap * (rate + 1), int(np.lcm(128, n)))
        self.negative_sampler = None if self.device_negatives \
            else NegativeSampler(rate, config.entity_count, rng)
        # 'contiguous' minibatches: in-order wrapping windows instead of
        # random ones (``shared/algorithms.py:36-39``).
        self.contiguous = config.optimizer.contiguous_sampling
        self._cursor = 0

    def sample_ids(self) -> tuple:
        """(batch edge ids, message-graph edge ids) into the train set."""
        return draw_subgraph(self.train, self.adj, self.graph_batch_size,
                             self.config.training.graph_split_size,
                             self.sampler, self.rng)

    def minibatch(self) -> np.ndarray:
        """The positives of a model without a graph (``engine.py:152-166``):
        the whole train set, or a ``BatchSize`` window or random draw."""
        n = len(self.train)
        if self.batch_size >= n:
            return self.train
        if self.contiguous:
            idx = np.arange(self._cursor, self._cursor + self.batch_size) % n
            self._cursor = int(idx[-1] + 1) % n
        else:
            idx = self.rng.choice(n, size=self.batch_size, replace=False)
        return self.train[idx]

    def next(self) -> TrainBatch:
        if not self.model.needs_graph():
            graph, positives, edge_ids = None, self.minibatch(), None
        else:
            with span("batch.sample"):
                batch_ids, split_ids = self.sample_ids()
            with span("batch.graph"):
                graph = self.model.make_graph(self.train[split_ids],
                                              to_device=False,
                                              shard=self.shard or (0, 1))
            positives = self.train[batch_ids]
            edge_ids = split_ids.astype(np.int32)
        if self.device_negatives:
            batch = self._padded(graph, positives, None, self.positives_pad,
                                 edge_ids)
        else:
            x, y = self.negative_sampler.transform(positives)
            batch = self._padded(graph, x, y, self.triple_pad, edge_ids)
        if self.model.has_state:
            batch = batch._replace(message_edge_ids=torch.from_numpy(
                edge_ids.astype(np.int64)))
        if self.shard is not None:
            batch = shard_batch(self.shard, batch)
        if not self.pin:
            return batch
        with span("batch.pin"):
            return batch.pin_memory()

    @staticmethod
    def _padded(graph, triples, labels, pad, edge_ids) -> TrainBatch:
        """``triples`` (and ``labels``) zero-padded to ``pad`` rows, with a
        mask of the real ones."""
        n = len(triples)
        xp = np.zeros((pad, 3), dtype=np.int32)
        mp = np.zeros((pad,), dtype=np.float32)
        xp[:n] = triples
        mp[:n] = 1.0
        yp = None
        if labels is not None:
            yp = np.zeros((pad,), dtype=np.float32)
            yp[:n] = labels
            yp = torch.from_numpy(yp)
        return TrainBatch(graph, torch.from_numpy(xp), torch.from_numpy(mp),
                          edge_ids, yp)

    # -- resumable host state (``engine.py:181-189``) ---------------------
    def state(self) -> dict:
        """All mutable host state that batch production consumes (the
        numpy RNG and the contiguous cursor): restoring it reproduces the
        future batch stream exactly."""
        return {"rng": self.rng.bit_generator.state, "cursor": self._cursor}

    def set_state(self, st: dict) -> None:
        self.rng.bit_generator.state = st["rng"]
        self._cursor = st["cursor"]


class QueryPipeline:
    """The 1-N batches of a model trained against every entity at once
    (``CompGCNModel.loss_kvsall``; the official CompGCN loader's
    ``TrainDataset``): every key (s, r) of the train graph and (o, r + R)
    of its inverse, with its label row, the entities that complete it
    there. A batch takes ``batch_size`` keys from a permutation of all of
    them, which is drawn anew from ``rng`` when it runs out; a batch that
    crosses its end takes the rest from the next one, so every batch is
    full and every step keeps one shape. The batch has no graph (the
    loop's whole train graph is the message graph of every step):
    ``triples`` [n, 3] int32 (s, r, 0), ``mask`` ones [n], ``labels``
    [n, V] bool and ``counts`` (``queries``, ``label_entries``)."""

    def __init__(self, model, config: RunConfig, dataset: KGDataset,
                 rng: np.random.Generator):
        train = np.asarray(dataset.train, dtype=np.int64).reshape(-1, 3)
        n_rel = config.relation_count
        s, r, o = train.T
        keys = np.concatenate([s * 2 * n_rel + r, o * 2 * n_rel + r + n_rel])
        tails = np.concatenate([o, s])
        order = np.lexsort((tails, keys))
        self.keys, starts = np.unique(keys[order], return_index=True)
        self.label_ptr = np.append(starts, len(order))
        self.label_ids = tails[order]
        self.n_entities = config.entity_count
        self.n_relations = n_rel
        self.n_positives = config.compgcn.batch_size
        self.split_size = len(train)
        self.rng = rng
        self.pin = model.device.type == "cuda"
        self._draw()

    def _draw(self) -> None:
        """A new permutation of the keys; the rng's state before it is
        what ``state`` restores."""
        self._perm_rng = self.rng.bit_generator.state
        self._perm = self.rng.permutation(len(self.keys))
        self._cursor = 0

    def next(self) -> TrainBatch:
        n = self.n_positives
        with span("batch.queries"):
            parts, need = [], n
            while need:
                take = self._perm[self._cursor:self._cursor + need]
                parts.append(take)
                need -= len(take)
                self._cursor += len(take)
                if self._cursor == len(self._perm):
                    self._draw()
            k = np.concatenate(parts)
            key = self.keys[k]
            triples = np.zeros((n, 3), dtype=np.int32)
            triples[:, 0] = key // (2 * self.n_relations)
            triples[:, 1] = key % (2 * self.n_relations)
            starts, sizes = self.label_ptr[k], np.diff(self.label_ptr)[k]
            total = int(sizes.sum())
            at = np.arange(total) + np.repeat(starts - (np.cumsum(sizes)
                                                        - sizes), sizes)
            labels = np.zeros((n, self.n_entities), dtype=np.bool_)
            labels[np.repeat(np.arange(n), sizes), self.label_ids[at]] = True
            batch = TrainBatch(None, torch.from_numpy(triples),
                               torch.ones(n), labels=torch.from_numpy(labels),
                               counts={"queries": n, "label_entries": total})
        if not self.pin:
            return batch
        with span("batch.pin"):
            return batch.pin_memory()

    def state(self) -> dict:
        """The rng's state before the current permutation and the place in
        it: restoring them draws the same permutation again and continues
        the batch stream exactly."""
        return {"rng": self._perm_rng, "cursor": self._cursor}

    def set_state(self, st: dict) -> None:
        self.rng.bit_generator.state = st["rng"]
        self._draw()
        self._cursor = st["cursor"]


class _SerialSource:
    """``prefetch=False``: each batch built on the consumer's thread after
    the card has finished the queued step, and copied before the step."""

    def __init__(self, pipeline: BatchPipeline, device: torch.device):
        self.pipeline = pipeline
        self.device = device

    def next(self) -> tuple:
        """(batch on the device, the sink of its ``batch.*`` spans): the
        step waits for all of the batch, so its ``fit.batch_wait`` span
        encloses the ``batch.build``."""
        if self.device.type == "cuda":
            # The batch's copies would wait for the queued step; waiting
            # here keeps that out of the batch's spans.
            torch.cuda.synchronize(self.device)
        with span("fit.batch_wait"), collect() as built, \
                span("batch.build"):
            batch = self.pipeline.next()
            with span("batch.copy"):
                batch = batch.to(self.device)
        return batch, built

    def states(self) -> tuple:
        return [self.pipeline.state()], 0

    def close(self) -> None:
        pass


class _Prefetcher:
    """Producer threads that build batches while the device steps
    (``engine.py:207-281``).

    Deterministic by construction: each pipeline feeds its own bounded
    queue and ``next()`` takes from them in turn, so the batch stream is a
    function of (pipeline seeds, ``start_offset``) whatever the threads'
    timing. Each queue item carries its pipeline's host state after the
    batch was made; ``states()`` gives each pipeline's state after its last
    consumed batch, which is what a resumed run restores.

    On the card each producer copies its batches from pinned memory with
    ``non_blocking=True`` on its own CUDA stream and records an event
    there; ``next()`` makes the current stream wait on that event and
    records the current stream on every device tensor of the batch, so
    that the caching allocator does not hand the memory to the side
    stream again before the step is done with it. The producers launch no
    kernel: they run host code and copies only. Each producer collects
    one sink of spans a batch (``batch.build`` and the ``batch.*`` spans
    inside it), which travels with the batch. A producer's exception is
    raised by ``next()``.
    """

    def __init__(self, pipelines: List[BatchPipeline], device: torch.device,
                 depth: int = 4, start_offset: int = 0):
        self.pipelines = list(pipelines)
        self.device = device
        n = len(self.pipelines)
        per_q = max(1, -(-depth // n))
        self.queues = [queue.Queue(maxsize=per_q) for _ in range(n)]
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        self._rr = start_offset % n
        # The state to restore per pipeline: after its last consumed batch
        # (initially the untouched state).
        self._consumed_state = [p.state() for p in self.pipelines]
        on_card = device.type == "cuda"
        self.threads = [
            threading.Thread(
                target=self._run, name=f"batch-producer-{k}", daemon=True,
                args=(p, q, torch.cuda.Stream(device) if on_card else None))
            for k, (p, q) in enumerate(zip(self.pipelines, self.queues))]
        for t in self.threads:
            t.start()

    def _run(self, pipeline: BatchPipeline, q: queue.Queue, stream) -> None:
        try:
            while not self._stop.is_set():
                with collect() as built, span("batch.build"):
                    batch, event = pipeline.next(), None
                    if stream is not None:
                        with span("batch.copy"), torch.cuda.stream(stream):
                            batch = batch.to(self.device, non_blocking=True)
                            event = torch.cuda.Event()
                            event.record(stream)
                    state = pipeline.state()
                item = (state, batch, event, built)
                while not self._stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # raised by next()
            self.error = e

    def next(self) -> tuple:
        """(batch on the device, the sink of its producer's spans); the
        ``fit.batch_wait`` span times this call's wait for the queue."""
        q = self.queues[self._rr]
        with span("fit.batch_wait"):
            while True:
                if self.error is not None:
                    raise self.error
                try:
                    st, batch, event, built = q.get(timeout=0.1)
                    break
                except queue.Empty:
                    continue
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.tensors():
                t.record_stream(current)
        self._consumed_state[self._rr] = st
        self._rr = (self._rr + 1) % len(self.queues)
        return batch, built

    def states(self) -> tuple:
        """(per-pipeline resume states, next round-robin index)."""
        return list(self._consumed_state), self._rr

    def close(self, timeout: float = 30.0) -> None:
        """Stop and join the producers, drop the batches made ahead, and
        put every pipeline back at its consumption point, so that the next
        batch stream continues where this one was consumed."""
        self._stop.set()
        for t in self.threads:
            t.join(timeout)
        for q in self.queues:
            while not q.empty():
                q.get_nowait()
        if not any(t.is_alive() for t in self.threads):
            for p, st in zip(self.pipelines, self._consumed_state):
                p.set_state(st)


def loss_kind(model: RGCNModel, negative_mode: str,
              device_negatives: bool) -> str:
    """The training objective by the JAX package's rule
    (``engine.py:391-410``): with device negatives and a factorizable
    decoder, 'factored' (binomial), 'split' or 'shared' as
    ``negative_mode`` says; anything else (the MLP decoder, or a host-tiled
    batch) 'tiled', the binomial protocol's tiled loss. A model trained
    against every entity (``CompGCNModel``) takes 'kvsall', its 1-N
    objective, whatever the mode."""
    if negative_mode not in ("binomial", "split", "shared"):
        raise ValueError(f"unknown negative mode {negative_mode!r}")
    if getattr(model, "objective", None) == "kvsall":
        return "kvsall"
    if device_negatives and getattr(model.decoder, "factorizable", False):
        return {"binomial": "factored", "split": "split",
                "shared": "shared"}[negative_mode]
    return "tiled"


class Draws(NamedTuple):
    """A step's random draws on the device: the loss's negatives, by loss
    kind (factored: values and corrupt_object [n, rate]; split:
    neg_subjects and neg_objects; shared: the pool [P]; tiled: the tiled
    triples, labels and mask, or none for a host-tiled batch), one
    dropout keep-mask per layer, and the encoder's other noise
    (``RGCNModel.draw_noise``)."""
    negatives: tuple
    keep_masks: list
    noise: EncoderNoise = EncoderNoise()

    def to(self, device) -> "Draws":
        return Draws(tuple(t.to(device) for t in self.negatives),
                     [m.to(device) for m in self.keep_masks],
                     self.noise.to(device))


def step_loss_and_grads(model: RGCNModel, kind: str, params,
                        batch: TrainBatch, draws: Draws,
                        group=None) -> tuple:
    """(loss, gradient tree) of the train-mode loss of ``kind``
    (``loss_kind``) on ``batch`` with ``draws``. A leaf the loss does not
    reach (the GCN layers' unused bias) gets a zero gradient, as under
    ``jax.grad``. ``group``: an edge mesh's process group, ``batch`` this
    rank's shard; the loss is then the global one and each gradient leaf
    N times this rank's share (``parallel/mesh.py``): see
    ``sharded_loss_and_grads``."""
    neg = draws.negatives
    common = dict(deterministic=False, keep_masks=draws.keep_masks,
                  noise=draws.noise, group=group)
    if kind == "tiled":
        args = (params, batch.graph) + (
            neg or (batch.triples, batch.labels, batch.mask))
        loss_fn = model.loss
    elif kind == "kvsall":
        args = (params, batch.graph, batch.triples, batch.labels, batch.mask)
        loss_fn = model.loss_kvsall
    else:
        args = (params, batch.graph, batch.triples, batch.mask) + neg
        loss_fn = {"factored": model.loss_binomial_factored,
                   "split": model.loss_structured,
                   "shared": model.loss_shared_negatives}[kind]
    return _value_and_grad(lambda: loss_fn(*args, **common), params)


def sharded_loss_and_grads(model: RGCNModel, kind: str, params,
                           batch: TrainBatch, draws: Draws,
                           mesh: EdgeMesh) -> tuple:
    """(global loss, gradient of the global loss) from this rank's
    ``batch`` shard and ``draws`` (its rows' negatives, the keep-masks and
    noise every rank shares): ``step_loss_and_grads`` with the mesh's
    all-reduces, then the gradients' mean over the ranks
    (``collectives.pmean``). The stored-message variant raises
    ValueError, as in the JAX package (``engine.py:335-337``)."""
    if model.has_state:
        raise ValueError("the stored-message variant does not support "
                         "mesh execution")
    loss, grads = step_loss_and_grads(model, kind, params, batch, draws,
                                      group=mesh.group)
    return loss, pmean(grads, mesh.group)


def make_sharded_train_step(model: RGCNModel, optimizer, mesh: EdgeMesh,
                            kind: str) -> Callable:
    """The mesh's train step (``parallel/mesh.py:75-151`` of the JAX
    package): ``step(params, opt_state, batch, draws) -> (opt_state,
    loss)`` takes ``sharded_loss_and_grads`` and applies the optimizer's
    update to ``params`` in place, the same update on every rank."""
    def step(params, opt_state, batch, draws):
        loss, grads = sharded_loss_and_grads(model, kind, params, batch,
                                             draws, mesh)
        updates, opt_state = optimizer.update(grads, opt_state)
        apply_updates(params, updates)
        return opt_state, loss
    return step


def step_seed(*words: int) -> int:
    """A 64-bit seed from integers (numpy's SeedSequence): a mesh step's
    generators are seeded from (seed, stream, step[, rank]), as the JAX
    package folds its step key."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def stateful_loss_and_grads(model: RGCNModel, params, cache: list,
                            batch: TrainBatch, draws: Draws) -> tuple:
    """(loss, gradient tree, new cache state) of the stored-message
    variant's ``loss_stateful`` on a host-tiled ``batch`` with the
    keep-masks of ``draws``, from the caches ``cache``."""
    out = {}

    def loss_fn():
        loss, out["cache"] = model.loss_stateful(
            params, cache, batch.graph, batch.message_edge_ids,
            batch.triples, batch.labels, batch.mask,
            keep_masks=draws.keep_masks)
        return loss
    loss, grads = _value_and_grad(loss_fn, params)
    return loss, grads, out["cache"]


def _value_and_grad(loss_fn, params) -> tuple:
    """(loss_fn() detached, gradient tree) with respect to every leaf of
    ``params``, a zero gradient for a leaf the loss does not reach."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        with span("step.forward"):
            loss = loss_fn()
        # On the card the backward runs on autograd's device thread; this
        # thread waits for it here.
        with span("step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def loss_and_grads(model: RGCNModel, params, batch: TrainBatch,
                   neg_values: torch.Tensor, corrupt_object: torch.Tensor,
                   keep_masks, noise: EncoderNoise = EncoderNoise()
                   ) -> tuple:
    """(loss, gradient tree) of the factored binomial loss for explicit
    draws."""
    return step_loss_and_grads(model, "factored", params, batch,
                               Draws((neg_values, corrupt_object),
                                     keep_masks, noise))


# -- the single-card step as one CUDA graph ---------------------------------

# The eager steps of a signature before its capture (the warm-up a capture
# needs: cuBLAS's workspace and the kernels' libraries made on the capture
# stream).
GRAPH_WARMUP_STEPS = 2
# The side stream of each device (StepGraphs._side_stream).
_SIDE_STREAMS: dict = {}


def graph_applies(device, mesh: Optional[EdgeMesh], vertex_sharded: bool,
                  has_state: bool) -> bool:
    """Whether a loop's steps may run as a CUDA graph: a single-card step
    on a CUDA device. A mesh's step (its collectives), the vertex-sharded
    step, the stored-message variant's (its caches change shape with the
    batch's edges) and a CPU step run op by op."""
    return torch.device(device).type == "cuda" and mesh is None \
        and not vertex_sharded and not has_state


def _step_inputs(batch: TrainBatch, draws: Draws) -> list:
    """The tensors a step reads from its batch and draws, in a fixed
    order, with None where the batch or the draws have none."""
    graph = [] if batch.graph is None else batch.graph.tensors()
    return graph + [batch.triples, batch.mask, batch.labels,
                    *draws.negatives, *draws.keep_masks, *draws.noise]


def step_signature(kind: str, params, batch: TrainBatch,
                   draws: Draws) -> tuple:
    """The key of a step's graph: the loss kind; the shape and dtype of
    each tensor the step reads from its batch and draws (None where one is
    absent), with the sizes of the message graph that are no tensor's
    shape; and the storage of the params' leaves, which the graph updates
    in place."""
    sizes = None if batch.graph is None else batch.graph.signature()
    described = tuple(None if t is None else (tuple(t.shape), t.dtype)
                      for t in _step_inputs(batch, draws))
    return (kind, sizes, len(draws.negatives), len(draws.keep_masks),
            described, tuple((p.data_ptr(), tuple(p.shape), p.dtype)
                             for p in tree_leaves(params)))


@dataclass
class _StepGraph:
    """The graph of one signature: its steps so far, the optimizer state
    it writes in place, and once captured the graph, its static inputs,
    its loss and the kernel launches its capture counted."""
    key: tuple
    steps: int = 0
    state: Optional[dict] = None
    graph: Optional["torch.cuda.CUDAGraph"] = None
    inputs: list = field(default_factory=list)
    loss: Optional[torch.Tensor] = None
    launches: dict = field(default_factory=dict)


class StepGraphs:
    """A loop's single-card step replayed as one CUDA graph, kept for one
    step signature (``step_signature``) at a time.

    A signature's first ``GRAPH_WARMUP_STEPS`` steps run op by op on a
    side stream, the next is captured on it and replayed, and later ones
    copy their batch and draws into the graph's static inputs and replay.
    A step of another signature drops the graph, and its memory pool with
    it, and starts that signature's warm-up. Every step writes the
    optimizer state it returns in place (``TrainLoop.in_place_step``); a
    state that is not that one (a resumed run's) is copied in first. The
    kernel wrappers do not run in a replay, so a replay adds the launches
    counted while its graph was captured to their counters
    (``ops.add_launches``): recorded counts, not counted launches. A
    capture that raises sends every later step of the loop to the eager
    step, logged once. ``counts``: the steps captured, replayed and run
    eagerly (the warm-up steps among them), and the failed captures."""

    def __init__(self, enabled: bool, log: Callable[[str], None]):
        self.enabled = enabled
        self.log = log
        self.current: Optional[_StepGraph] = None
        self.counts = {"captures": 0, "replays": 0, "eager": 0,
                       "failed_captures": 0}

    def route(self, key) -> str:
        """The way a step of signature ``key`` runs, by bookkeeping alone:
        "eager" (graphs do not apply or a capture failed), "warmup",
        "capture" or "replay"."""
        if not self.enabled:
            return "eager"
        if self.current is None or self.current.key != key:
            self.current = _StepGraph(key)
        if self.current.graph is not None:
            return "replay"
        self.current.steps += 1
        return "warmup" if self.current.steps <= GRAPH_WARMUP_STEPS \
            else "capture"

    def release(self) -> None:
        """Drop the graph, its static inputs and its optimizer state (the
        state a step returned stays valid); the next step starts a
        warm-up."""
        self.current = None

    def step(self, loop: "TrainLoop", params, opt_state, batch: TrainBatch,
             draws: Draws) -> tuple:
        """(route taken: "eager", "capture" or "replay", opt_state, loss)
        of one step of ``loop`` on ``batch`` with ``draws``."""
        key = step_signature(loop.loss_kind, params, batch, draws) \
            if self.enabled else None
        route = self.route(key)
        if route == "eager":
            self.counts["eager"] += 1
            return ("eager",) + loop.eager_step(params, opt_state, batch,
                                                draws)
        entry = self.current
        if entry.state is None:
            entry.state = map_tree(torch.clone, opt_state)
        elif opt_state is not entry.state:
            for mine, given in zip(tree_leaves(entry.state),
                                   tree_leaves(opt_state)):
                if mine is not given:
                    mine.copy_(given)
        if route == "replay":
            with span("step.replay"):
                for static, t in zip(entry.inputs,
                                     _step_inputs(batch, draws)):
                    if static is not None:
                        static.copy_(t)
                entry.graph.replay()
                loss = entry.loss.clone()
            add_launches(entry.launches)
            self.counts["replays"] += 1
            return "replay", entry.state, loss
        if route == "warmup":
            self.counts["eager"] += 1
            return "eager", entry.state, self._on_side_stream(
                batch.triples.device,
                lambda: loop.in_place_step(params, entry.state, batch,
                                           draws))
        try:
            loss = self._capture(entry, loop, params, batch, draws)
        except RuntimeError as e:
            self.enabled = False
            self.release()
            self.counts["failed_captures"] += 1
            self.counts["eager"] += 1
            self.log(f"step graphs: the capture failed ({e}); every later "
                     f"step runs eagerly")
            return ("eager",) + loop.eager_step(params, entry.state, batch,
                                                draws)
        self.counts["captures"] += 1
        return "capture", entry.state, loss

    @staticmethod
    def _side_stream(device) -> "torch.cuda.Stream":
        """One stream a device for every loop's warm-up and capture, as
        torch.cuda.graph keeps one (each new stream gets cuBLAS
        workspaces of its own). torch.cuda.Stream hands out the 32 pooled
        streams of a priority in turn, so a producer's copy stream
        (priority 0) can be one made before it; taken from the high
        priority pool, the side stream is never a producer's, whose copies
        would otherwise join a capture."""
        device = torch.device(device)
        if device not in _SIDE_STREAMS:
            _SIDE_STREAMS[device] = torch.cuda.Stream(device, priority=-1)
        return _SIDE_STREAMS[device]

    def _on_side_stream(self, device, fn):
        """``fn()`` on the side stream of ``device``, ordered after the
        current stream's work and before its next."""
        current = torch.cuda.current_stream(device)
        side = self._side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        return out

    def _capture(self, entry: _StepGraph, loop: "TrainLoop", params,
                 batch: TrainBatch, draws: Draws) -> torch.Tensor:
        """Capture the step on copies of ``batch`` and ``draws``, which
        stay its static inputs, then replay it once for this step; returns
        its loss. The launches counted while capturing are this step's."""
        static_batch = TrainBatch(
            None if batch.graph is None else batch.graph.clone(),
            batch.triples.clone(), batch.mask.clone(),
            labels=None if batch.labels is None else batch.labels.clone())
        static_draws = Draws(
            tuple(t.clone() for t in draws.negatives),
            [m.clone() for m in draws.keep_masks],
            EncoderNoise(*(None if t is None else t.clone()
                           for t in draws.noise)))
        graph = torch.cuda.CUDAGraph()
        before = launch_counters()
        # The graph's memory pool can take no block the allocator has
        # cached, and the allocator frees none while a capture runs, so the
        # cached blocks go back to the device first, as torch.cuda.graph
        # does (its own entry also empties the pinned host memory's cache,
        # which the producers' batches reuse, so its calls are made here).
        # "thread_local": the producer threads' copies and pinned
        # allocations go on during the capture.
        torch.cuda.empty_cache()
        try:
            with torch.cuda.stream(self._side_stream(batch.triples.device)):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = loop.in_place_step(params, entry.state,
                                             static_batch, static_draws)
                finally:
                    graph.capture_end()
        except RuntimeError:
            # Nothing ran; the counts return to the step's start.
            add_launches({k: before.get(k, 0) - n
                          for k, n in launch_counters().items()})
            raise
        after = launch_counters()
        entry.launches = {k: n - before.get(k, 0) for k, n in after.items()
                          if n != before.get(k, 0)}
        entry.graph, entry.loss = graph, out
        entry.inputs = _step_inputs(static_batch, static_draws)
        graph.replay()
        return out.clone()


def model_state(model) -> dict:
    """A checkpoint's ``extra`` entries of a model's running statistics
    (``CompGCNModel.batch_stats``, as numpy), or none."""
    stats = getattr(model, "batch_stats", None)
    return {} if stats is None else {"batch_stats": params_to_numpy(stats)}


def restore_model_state(model, extra: dict) -> None:
    """Copy a checkpoint's running statistics into the model's tensors, in
    place: a captured step keeps their addresses."""
    saved = extra.get("batch_stats")
    if saved is None or getattr(model, "batch_stats", None) is None:
        return
    for mine, value in zip(tree_leaves(model.batch_stats),
                           tree_leaves(saved)):
        mine.copy_(torch.from_numpy(np.array(value)))


@dataclass
class FitResult:
    params: dict
    opt_state: dict
    iterations: int
    stopped_early: bool
    last_loss: float
    best_score: Optional[float]
    # One dict per step: iteration, loss, batch_ms (the wall time of the
    # batch's batch.build span: sampling, split, layouts and the copy to
    # the device; with prefetch in the producer, the copy only enqueued),
    # wait_ms (the wall time of the step's fit.batch_wait span: how long
    # it waited for its batch; batch_ms without prefetch), step_ms (CUDA
    # events around the device step; None on the CPU), the aggregation
    # kernels' forward and twin launches in the step
    # (staircase2.launch_counts; a validation encode counts in none; on a
    # replayed step the counts its graph's capture recorded, since no
    # wrapper runs in a replay),
    # a 1-N step's counts (queries, label_entries: the positives of its
    # label rows; composed_edges: the message edges and self-loops its
    # encode composes), counted on the host from the batch and the graph,
    # so a replayed step counts what an eager one does,
    # graph (how the step ran: "eager", "capture" or "replay";
    # StepGraphs), spans (the fit loop's sink for the step: fit.*,
    # step.* and model.encode; a replayed step's step.replay in place of
    # step.forward, step.backward and step.optimizer) and batch_spans (the
    # sink of the producer that built its batch: batch.*), each name ->
    # [wall_ms, cpu_ms, count] (observability.span).
    steps: list = field(default_factory=list)


class TrainLoop:
    """``fit`` with the reference's loss reporter, early stopper and model
    saver, on one device or, with ``mesh``, edge-partitioned over its
    ranks, or with ``vertex_sharded`` too, vertex-sharded (the module's
    docstring; ``vs_overlap`` is ``VertexShardedEncoder``'s overlap).
    ``negative_mode`` and ``device_negatives`` choose the objective
    (``loss_kind``); ``negative_pool_size`` is the shared pool's size. A
    model with stored-message state takes host-tiled batches and
    the tiled loss whatever they say, and the loop keeps its caches in
    ``cache_state``."""

    def __init__(self, model: RGCNModel, config: RunConfig,
                 dataset: KGDataset, *,
                 scoring_function: Optional[Callable] = None,
                 sampler: str = "neighborhood",
                 seed: int = 0,
                 log: Callable[[str], None] = print,
                 prefetch: bool = True,
                 prefetch_threads: int = 2,
                 metrics_path: Optional[str] = None,
                 device_negatives: bool = True,
                 negative_mode: str = "binomial",
                 negative_pool_size: int = 512,
                 mesh: Optional[EdgeMesh] = None,
                 vertex_sharded: bool = False, vs_overlap: bool = False):
        if mesh is not None and model.device != mesh.device:
            raise ValueError(f"the model is on {model.device}, this rank's "
                             f"device is {mesh.device}")
        if vertex_sharded and mesh is None:
            raise ValueError("vertex_sharded requires a mesh")
        if vertex_sharded and negative_mode != "binomial":
            raise ValueError("vertex_sharded training uses the "
                             "host-sampled binomial protocol")
        require_single_card(config, mesh is not None, vertex_sharded)
        self.model = model
        self.config = config
        self.scoring_function = scoring_function
        self.log = log
        self.prefetch = prefetch
        self.seed = seed
        self.mesh = mesh
        self.metrics = MetricLogger(metrics_path, echo=False)
        self.host_rng = np.random.default_rng(seed)
        device_negatives = device_negatives and not model.has_state
        # The objective (``loss_kind``); the shared pool has
        # ``negative_pool_size`` entities whatever the rate.
        self.loss_kind = loss_kind(model, negative_mode, device_negatives)
        self.negative_pool_size = negative_pool_size
        shard = {} if mesh is None else dict(shard_multiple=mesh.world_size,
                                             shard_rank=mesh.rank)
        # The other producers' pipelines are seeded as the JAX package
        # seeds them (``engine.py:380-385``).
        extra_seeds = [seed + 1000 + w
                       for w in range(max(0, prefetch_threads - 1))] \
            if prefetch else []
        self.vse = None
        # The 1-N objective's message graph: the whole train graph, on the
        # device, the same for every step (``QueryPipeline``).
        self.train_graph = None
        if self.loss_kind == "kvsall":
            # One producer: the batches follow one permutation stream.
            self.pipeline = QueryPipeline(model, config, dataset,
                                          self.host_rng)
            self._extra_pipelines = []
            self.train_graph = model.make_graph(dataset.train)
        elif vertex_sharded:
            from ..parallel.vertex_sharded import (VertexShardedBatchPipeline,
                                                   VertexShardedEncoder)
            self.vse = VertexShardedEncoder(model, mesh, overlap=vs_overlap)
            # Factored binomial on the decoder halo by default; with
            # device_negatives=False the host-tiled batch (the JAX
            # package's rule, ``engine.py:346-351``).
            factored = getattr(model.decoder, "factorizable", False) \
                and device_negatives
            self.loss_kind = "factored" if factored else "tiled"
            self.pipeline = VertexShardedBatchPipeline(
                self.vse, config, dataset, self.host_rng, sampler,
                factored=factored, shard_rank=mesh.rank)
            # The other producers' pipelines take the first one's budgets.
            self._extra_pipelines = [
                VertexShardedBatchPipeline(
                    self.vse, config, dataset, np.random.default_rng(s),
                    sampler, budgets=self.pipeline.budgets,
                    factored=factored, shard_rank=mesh.rank)
                for s in extra_seeds]
        else:
            self.pipeline = BatchPipeline(model, config, dataset,
                                          self.host_rng, sampler,
                                          device_negatives, **shard)
            self._extra_pipelines = [
                BatchPipeline(model, config, dataset,
                              np.random.default_rng(s), sampler,
                              device_negatives, **shard)
                for s in extra_seeds]
        self._resume_rr = 0
        self.optimizer = build_optimizer(config.optimizer)
        self.vs_step = None if self.vse is None \
            else self.vse.make_train_step(self.optimizer)
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(seed)
        # On a mesh: the generator of this rank's corruptions; both are
        # seeded anew every step (``seed_step``).
        self.rank_generator = None if mesh is None \
            else torch.Generator(device=model.device)
        self.timer = StepTimer()
        self.cache_state = model.init_cache_state() if model.has_state \
            else None
        self.graphs = StepGraphs(graph_applies(
            model.device, mesh, vertex_sharded, model.has_state), log)
        # The steps captured, replayed and run eagerly, and the failed
        # captures (``StepGraphs.counts``); the way the last step ran.
        self.graph_counts = self.graphs.counts
        self.last_step = "eager"

    def init_state(self, seed: int = 0) -> tuple:
        """Seeded params and their optimizer state; vertex-sharded, padded
        to v_pad entity rows."""
        params = self.model.init_params(
            torch.Generator().manual_seed(seed))
        if self.vse is not None:
            params = self.vse.pad_params(params)
        return params, self.optimizer.init(params)

    def seed_step(self, step: int) -> None:
        """On a mesh, seed the step's generators from (seed, step): the
        shared one as the JAX package folds 778 into its step key, this
        rank's as it folds 777 and the rank (``mesh.py:111-117``)."""
        self.generator.manual_seed(step_seed(self.seed, 778, step))
        self.rank_generator.manual_seed(
            step_seed(self.seed, 777, step, self.mesh.rank))

    def draw(self, batch: TrainBatch) -> Draws:
        """The step's random draws on the device, from the loop's
        generator: the corruptions of ``loss_kind`` (none for a host-tiled
        batch), then one dropout keep-mask per layer, then the encoder's
        other noise, which only a configuration that uses it draws (so the
        stream of every other configuration stays as it was). On a mesh the
        corruptions of this rank's rows come from its own generator, and
        the shared pool from the one every rank shares."""
        rate = self.config.training.negative_sample_rate
        n_entities, gen = self.config.entity_count, self.generator
        rows_gen = gen if self.mesh is None else self.rank_generator
        kind = self.loss_kind
        with span("step.draws"):
            if kind == "factored":
                neg = device_negative_parts(batch.triples, rate, n_entities,
                                            rows_gen)
            elif kind == "split":
                neg = device_negative_entities_split(batch.triples, rate,
                                                     n_entities, rows_gen)
            elif kind == "shared":
                neg = (device_negative_pool(self.negative_pool_size,
                                            n_entities, gen),)
            elif kind == "kvsall":
                neg = ()
            elif batch.labels is None:
                neg = device_negative_sample(batch.triples, batch.mask, rate,
                                             n_entities, rows_gen)
            else:
                neg = ()
            keep_masks = self.model.draw_keep_masks(gen)
            return Draws(tuple(neg), keep_masks, self.model.draw_noise(gen))

    def train_step(self, params, opt_state, batch: TrainBatch) -> tuple:
        """One step (``engine.py:411-483``, the stored variant's
        ``:520-535``); updates ``params`` in place, and ``cache_state``
        for the stored variant. Returns (opt_state, loss as a 0-d tensor
        on the device). The draws are taken op by op (``draw``); a
        single-card step on the card then runs as a CUDA graph once its
        signature has one (``StepGraphs``; ``last_step`` says how it ran),
        else op by op (``eager_step``). On a mesh, after ``seed_step``, the
        sharded loss and the gradients' mean over the ranks
        (``sharded_loss_and_grads``), then the same update; vertex-sharded,
        ``VertexShardedEncoder.make_train_step``'s step on this rank's
        state."""
        if self.vse is not None:
            keep_masks = self.vse.draw_keep_masks(self.generator,
                                                  self.rank_generator)
            self.last_step = "eager"
            self.graph_counts["eager"] += 1
            return self.vs_step(params, opt_state, batch, keep_masks)
        if self.train_graph is not None:
            batch = batch._replace(graph=self.train_graph)
        draws = self.draw(batch)
        if self.mesh is None and not self.model.has_state:
            self.last_step, opt_state, loss = self.graphs.step(
                self, params, opt_state, batch, draws)
            return opt_state, loss
        self.last_step = "eager"
        self.graph_counts["eager"] += 1
        if self.mesh is not None:
            loss, grads = sharded_loss_and_grads(
                self.model, self.loss_kind, params, batch, draws, self.mesh)
        else:
            loss, grads, self.cache_state = stateful_loss_and_grads(
                self.model, params, self.cache_state, batch, draws)
        return self._update(params, opt_state, grads), loss

    def eager_step(self, params, opt_state, batch: TrainBatch,
                   draws: Draws) -> tuple:
        """The single-device step op by op on ``draws``: the loss of
        ``loss_kind`` and its gradients, then the optimizer's update of
        ``params`` in place. Returns (opt_state, loss)."""
        loss, grads = step_loss_and_grads(self.model, self.loss_kind,
                                          params, batch, draws)
        return self._update(params, opt_state, grads), loss

    def in_place_step(self, params, opt_state, batch: TrainBatch,
                      draws: Draws) -> torch.Tensor:
        """``eager_step`` with the new optimizer state copied into
        ``opt_state``'s tensors (the same values: the update is computed
        as before), as a CUDA graph of the step must write it; returns the
        loss."""
        new_state, loss = self.eager_step(params, opt_state, batch, draws)
        for mine, new in zip(tree_leaves(opt_state),
                             tree_leaves(new_state)):
            mine.copy_(new)
        return loss

    def _update(self, params, opt_state, grads) -> dict:
        with span("step.optimizer"):
            updates, opt_state = self.optimizer.update(grads, opt_state)
            apply_updates(params, updates)
        return opt_state

    def _source(self):
        device = self.model.device
        if not self.prefetch:
            return _SerialSource(self.pipeline, device)
        return _Prefetcher([self.pipeline] + self._extra_pipelines, device,
                           start_offset=self._resume_rr)

    def fit(self, params=None, opt_state=None, *,
            max_iterations: Optional[int] = None,
            max_seconds: Optional[float] = None,
            start_iteration: int = 0,
            checkpoint_path: Optional[str] = None) -> FitResult:
        """Train from ``start_iteration`` until the early stopper fires,
        ``max_iterations`` (the settings' ``MaxIterations`` if not given) or
        ``max_seconds``; save under ``checkpoint_path`` at every
        ``SaveEveryN`` (default ``CheckEvery``) unless the stopper fired.
        On a mesh every rank calls this; the params and optimizer state
        start as rank 0's, every rank takes rank 0's time cap and
        validation score, and only rank 0 saves."""
        cfg = self.config.optimizer
        if params is None:
            params, opt_state = self.init_state()
        mesh = self.mesh
        if self.vse is not None:
            params, opt_state = self._place_sharded(params, opt_state)
        elif mesh is not None:
            params, opt_state = replicate(mesh, (params, opt_state))
        max_iter = max_iterations if max_iterations is not None \
            else cfg.max_iterations
        check_every = cfg.early_stopping_check_every
        save_every = cfg.save_every_n or check_every
        report_every = cfg.report_train_loss_every
        on_card = self.model.device.type == "cuda"
        records, pending = [], []
        cumulative_loss, loss = 0.0, float("nan")
        previous_score = best_score = None
        stopped = False

        def process_pending():
            nonlocal cumulative_loss, loss
            with span("fit.pending"):
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
                        if it_ - report_every < start_iteration + 1:
                            # Resumed mid-window: the sum holds only the
                            # steps since the resume; no mislabelled
                            # partial average.
                            continue
                        self.log(f"Average train loss for iteration "
                                 f"{it_ - report_every}-{it_ - 1}: {avg}")
                        self.metrics.log("train_loss", iteration=it_ - 1,
                                         loss=avg, **self.timer.summary())
                pending.clear()

        source = self._source()
        started = time.time()
        i = start_iteration
        try:
            while not stopped:
                # One sink of spans a step; a break at the top leaves the
                # loop before the step begins.
                with collect() as sink, span("fit.step"):
                    if max_iter is not None and i >= max_iter:
                        break
                    if max_seconds is not None:
                        late = time.time() - started > max_seconds
                        if mesh is not None:
                            late = bool(broadcast_value(
                                float(late), mesh.group, mesh.device))
                        if late:
                            break
                    i += 1
                    if mesh is not None:
                        self.seed_step(i)
                    batch, built = source.next()
                    fwd0, twin0 = staircase2.launch_counts()
                    events = None
                    if on_card:
                        events = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                        events[0].record()
                    with span("fit.train_step"):
                        opt_state, loss_dev = self.train_step(
                            params, opt_state, batch)
                    if on_card:
                        events[1].record()
                    fwd1, twin1 = staircase2.launch_counts()
                    rec = {"iteration": i, "step_ms": None,
                           "launches": fwd1 - fwd0,
                           "twin_launches": twin1 - twin0,
                           "graph": self.last_step,
                           **(getattr(batch, "counts", None) or {})}
                    if self.train_graph is not None:
                        rec["composed_edges"] = self.train_graph.n_edges \
                            + self.config.entity_count
                    records.append(rec)
                    pending.append((rec, loss_dev, events))
                    del batch

                    # TrainLossReporter (shared/algorithms.py:82-116)
                    if i == 1 or (report_every and i % report_every == 1):
                        process_pending()

                    # EarlyStopper (shared/algorithms.py:119-161)
                    if self.scoring_function is not None and check_every \
                            and i % check_every == 0:
                        process_pending()
                        with span("fit.check"):
                            score = self.scoring_function(params)
                            if mesh is not None:
                                score = broadcast_value(score, mesh.group,
                                                        mesh.device)
                        self.log(f"Tested validation score at iteration "
                                 f"{i}. Result: {score}")
                        self.metrics.log("validation", iteration=i,
                                         score=score)
                        if best_score is None or score > best_score:
                            best_score = score
                        if previous_score is not None \
                                and not score > previous_score:
                            if i > cfg.early_stopping_burnin:
                                self.log("Stopping criterion reached.")
                                stopped = True
                            else:
                                self.log("Ignoring criterion while in "
                                         "burn-in phase.")
                        previous_score = score

                    # ModelSaver (shared/algorithms.py:61-79); skipped when
                    # the stopper fired, matching the decorator order.
                    if not stopped and checkpoint_path and save_every \
                            and i % save_every == 0:
                        with span("fit.save"):
                            # Vertex-sharded, every rank joins the gather.
                            saved = self._whole(params, opt_state)
                            if is_coordinator():
                                process_pending()
                                self.save(checkpoint_path, *saved, i,
                                          *source.states())
                                self.log("saving...")
                rec["spans"] = spans_ms(sink)
                rec["batch_spans"] = spans_ms(built)
                rec["wait_ms"] = rec["spans"]["fit.batch_wait"][0]
                rec["batch_ms"] = rec["batch_spans"]["batch.build"][0]
                # The global batch's edges, on every rank.
                self.timer.add(sink, edges=self.pipeline.split_size)
        finally:
            self._resume_rr = source.states()[1]
            source.close()
        process_pending()
        params, opt_state = self._whole(params, opt_state)
        return FitResult(params=params, opt_state=opt_state, iterations=i,
                         stopped_early=stopped, last_loss=loss,
                         best_score=best_score, steps=records)

    def _place_sharded(self, params, opt_state) -> tuple:
        """This rank's vertex-sharded state of padded ``params`` and
        ``opt_state``; one-device params are padded and the optimizer
        state reinitialised (``engine.py:552-566``)."""
        if params["input_transform"]["W"].shape[0] != self.vse.v_pad:
            self.log("vertex-sharded fit: padding single-chip-shaped "
                     "params to the sharded layout and REINITIALIZING "
                     "optimizer state (existing moments, e.g. from a "
                     "single-chip checkpoint, are discarded)")
            params = self.vse.pad_params(params)
            opt_state = self.optimizer.init(params)
        return self.vse.place_state(params), self.vse.place_state(opt_state)

    def _whole(self, params, opt_state) -> tuple:
        """The padded trees of a vertex-sharded run (gathered from every
        rank); ``params`` and ``opt_state`` as they are otherwise."""
        if self.vse is None:
            return params, opt_state
        return self.vse.gather_state(params), \
            self.vse.gather_state(opt_state)

    def save(self, checkpoint_path: str, params, opt_state, step: int,
             pipeline_states: list, rr: int) -> str:
        """A checkpoint the JAX package's ``restore`` reads: params in its
        tree, the optimizer state in the port's (optax's fields), the host
        RNG and each pipeline's state at its consumption point with the
        round-robin index, and the torch generator's state as uint8 in
        ``extra``. ``rng_key`` holds ``jax.random.PRNGKey(seed)``'s layout."""
        return ckpt_lib.save(
            checkpoint_path, params=params_to_numpy(params),
            opt_state=params_to_numpy(opt_state), step=step,
            rng_key=np.array([0, self.seed & 0xFFFFFFFF], dtype=np.uint32),
            host_rng_state=self.host_rng.bit_generator.state,
            extra={"pipeline_states": pipeline_states, "rr": rr,
                   "torch_generator":
                       self.generator.get_state().numpy().copy(),
                   **model_state(self.model)})

    def restore(self, checkpoint_path: str) -> tuple:
        """(params, opt_state, step) of the newest checkpoint under
        ``checkpoint_path``, the port's or the JAX package's, with the
        host RNG, every pipeline's state and the round-robin index
        restored, so the batch stream continues exactly.

        A port checkpoint restores the torch generator's state. A JAX
        checkpoint has a JAX key instead, which cannot seed torch: the
        device generator is then seeded from (seed, step), so the device
        draws of the resumed run are the port's own, not JAX's. Its optax
        state is read by ``opt_state_from_jax``.

        The stored-message variant's caches are not in checkpoints (the
        JAX package's neither): they restart from zero, so a resumed
        stored run is not the uninterrupted one."""
        state = ckpt_lib.restore_latest(checkpoint_path)
        if state is None:
            raise FileNotFoundError(f"no checkpoint at {checkpoint_path}")
        device = self.model.device
        step = int(state["step"])
        params = params_from_jax(state["params"], device)
        opt_state = state["opt_state"]
        if isinstance(opt_state, tuple):  # optax's chain state
            opt_state = opt_state_from_jax(
                opt_state, self.config.optimizer.algorithm, device)
        else:
            opt_state = map_tree(
                lambda a: torch.from_numpy(np.array(a)).to(device), opt_state)
        extra = state.get("extra") or {}
        restore_model_state(self.model, extra)
        if self.model.has_state:
            self.cache_state = self.model.init_cache_state()
        if extra.get("torch_generator") is not None:
            self.generator.set_state(
                torch.from_numpy(np.array(extra["torch_generator"])))
        else:
            self.generator.manual_seed(int(np.random.SeedSequence(
                [self.seed, step]).generate_state(1, np.uint64)[0]))
        if state.get("host_rng_state"):
            self.host_rng.bit_generator.state = state["host_rng_state"]
        pipe_states = extra.get("pipeline_states")
        if pipe_states:
            for p, st in zip([self.pipeline] + self._extra_pipelines,
                             pipe_states):
                p.set_state(st)
            self._resume_rr = extra.get("rr", 0)
        return params, opt_state, step

    def resume(self, checkpoint_path: str, **fit_kwargs) -> FitResult:
        """Restore the newest checkpoint and continue fitting
        (``engine.py:792-814``); the resumed batch stream and, on the same
        device, the run are those of an uninterrupted run."""
        params, opt_state, step = self.restore(checkpoint_path)
        return self.fit(params, opt_state, start_iteration=step,
                        checkpoint_path=checkpoint_path, **fit_kwargs)
