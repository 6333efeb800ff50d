"""Metric records, step timing and profiler traces
(``relationprediction_tpu/observability.py``).

``MetricLogger`` appends one JSON object a record to a file and may echo
it; on an edge mesh only rank 0 does either. ``StepTimer`` counts steps/s
and edges/s over a run (a mesh's loop counts the global batch's edges and
triples on every rank), and the mean of the last ``window_size`` steps.
Host clock: a step timed here ends when the host has queued it, and
PyTorch waits for the card at the next read of a loss or the next
synchronize. ``trace`` records a ``torch.profiler``
trace of the enclosed block."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

from .parallel.distributed import is_coordinator


class MetricLogger:
    """Append-only JSONL metric log with optional stdout echo, written and
    echoed by the coordinator only (rank 0 of a process group, or a
    process without one)."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        if not is_coordinator():
            path, echo = None, False
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, kind: str, **fields: Any) -> None:
        record = {"ts": time.time(), "kind": kind, **fields}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.echo:
            body = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{kind}] {body}")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


@dataclass
class StepStats:
    steps: int = 0
    total_seconds: float = 0.0
    total_edges: int = 0
    total_triples: int = 0
    window: list = field(default_factory=list)

    @property
    def edges_per_sec(self) -> float:
        return self.total_edges / self.total_seconds if self.total_seconds \
            else 0.0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.total_seconds if self.total_seconds else 0.0


class StepTimer:
    """Accumulates per-step timing and throughput counters.

    Usage::

        with timer.step(edges=n_edges, triples=n_triples):
            run_train_step()
    """

    def __init__(self, window_size: int = 100):
        self.stats = StepStats()
        self.window_size = window_size

    @contextlib.contextmanager
    def step(self, edges: int = 0, triples: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        s = self.stats
        s.steps += 1
        s.total_seconds += dt
        s.total_edges += edges
        s.total_triples += triples
        s.window.append(dt)
        if len(s.window) > self.window_size:
            s.window.pop(0)

    def summary(self) -> Dict[str, float]:
        s = self.stats
        recent = sum(s.window) / len(s.window) if s.window else 0.0
        return {
            "steps": s.steps,
            "edges_per_sec": round(s.edges_per_sec, 1),
            "steps_per_sec": round(s.steps_per_sec, 3),
            "recent_step_ms": round(recent * 1e3, 2),
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Record a ``torch.profiler`` trace of the enclosed block, host
    operators and (where a card is present) its kernels and copies, and
    write it as a Chrome trace into ``log_dir`` (default ``torch-trace``
    under the temporary directory); yields the file's path
    (``observability.py:104-112`` of the JAX package)."""
    import torch

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
