"""Step timing with throughput counters (``relationprediction_tpu/
observability.py:48-101``): steps/s and edges/s over a run, and the mean
of the last ``window_size`` steps. Host clock: a step timed here ends when
the host has queued it, and PyTorch waits for the card at the next
host-to-device copy of a batch or read of a loss."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator


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
    """Accumulates per-step timing and throughput counters.

    Usage::

        with timer.step(edges=n_edges):
            run_train_step()
    """

    def __init__(self, window_size: int = 100):
        self.stats = StepStats()
        self.window_size = window_size

    @contextlib.contextmanager
    def step(self, edges: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
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
