"""Metric records, spans, step timing and profiler traces
(``relationprediction_tpu/observability.py``).

``MetricLogger`` appends one JSON object a record to a file and may echo
it; on an edge mesh only rank 0 does either. ``span(name)`` times the
enclosed block by the wall clock and the calling thread's CPU clock, and
adds both, with a count, under ``name`` to the sink that ``collect()``
installed on the thread: the fit loop collects one sink a step and each
batch producer one a batch (``FitResult.steps``' ``spans`` and
``batch_spans``). Wall minus CPU is the time the thread was not running:
blocked, waiting for the interpreter lock, or preempted. While a
``torch.profiler`` session records, a span is also a ``record_function``
range of the trace. ``StepTimer`` counts steps/s and edges/s over a run
from the fit loop's ``fit.step`` spans (a mesh's loop counts the global
batch's edges on every rank), and the mean of the last ``window_size``
steps. ``trace`` records a ``torch.profiler`` trace of the enclosed
block."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import torch

from .parallel.distributed import is_coordinator

# Whether a profiler session records now: false outside one and in its
# schedule's idle steps.
_profiling = torch._C._autograd._profiler_enabled


class _Local(threading.local):
    sink: Optional[dict] = None  # each thread's own; None until collect()


_local = _Local()


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


@contextlib.contextmanager
def collect() -> Iterator[dict]:
    """Install a new sink on the calling thread for the enclosed block and
    yield it: each span the thread closes meanwhile adds
    ``[wall_ns, cpu_ns, count]`` under its name. The thread's previous
    sink is put back at the end."""
    sink: dict = {}
    previous = _local.sink
    _local.sink = sink
    try:
        yield sink
    finally:
        _local.sink = previous


class span:
    """``with span(name):`` adds the block's wall time
    (``time.perf_counter_ns``), the calling thread's CPU time
    (``time.thread_time_ns``) and a count of one under ``name`` to the
    thread's sink, where it has one (``collect``), and, while a profiler
    session records, encloses the block in
    ``torch.profiler.record_function(name)``."""

    __slots__ = ("name", "_sink", "_range", "_wall", "_cpu")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._sink = _local.sink
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._sink is not None:
            # The wall clock's interval encloses the CPU clock's.
            self._wall = time.perf_counter_ns()
            self._cpu = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> None:
        sink = self._sink
        if sink is not None:
            cpu = time.thread_time_ns() - self._cpu
            wall = time.perf_counter_ns() - self._wall
            total = sink.get(self.name)
            if total is None:
                sink[self.name] = [wall, cpu, 1]
            else:
                total[0] += wall
                total[1] += cpu
                total[2] += 1
        if self._range is not None:
            self._range.__exit__(*exc)


def spans_ms(sink: dict) -> Dict[str, list]:
    """``sink`` as name -> [wall_ms, cpu_ms, count]."""
    return {k: [w * 1e-6, c * 1e-6, n] for k, (w, c, n) in sink.items()}


@dataclass
class StepStats:
    steps: int = 0
    total_seconds: float = 0.0
    total_edges: int = 0
    window: list = field(default_factory=list)

    @property
    def edges_per_sec(self) -> float:
        return self.total_edges / self.total_seconds if self.total_seconds \
            else 0.0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.total_seconds if self.total_seconds else 0.0


class StepTimer:
    """Accumulates per-step timing and throughput counters from the wall
    time of each step's ``fit.step`` span: the whole iteration of the fit
    loop, its batch's wait, the step's dispatch, the loss reads, the
    validation check and the save included.

    Usage::

        timer.add(sink, edges=n_edges)   # after the step's span closed
    """

    def __init__(self, window_size: int = 100):
        self.stats = StepStats()
        self.window_size = window_size

    def add(self, sink: dict, edges: int = 0) -> None:
        dt = sink["fit.step"][0] * 1e-9
        s = self.stats
        s.steps += 1
        s.total_seconds += dt
        s.total_edges += edges
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
