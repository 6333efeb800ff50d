"""Cells, configurations, traffic mixes and per-layer metrics, found by
name, and the run of one cell.

A cell ``<name>`` is ``workloads/<name>.json`` (its configuration, its
traffic mix and the limits of its comparison); a configuration is
``configs/<name>.json`` (the settings file's tree as it is run, its source
and what was reduced); a traffic mix is ``traffic/<name>.json`` (the
held-out sample and published counts of the graph, the window path under
``paths/`` and its parameters; ``samples/<name>.csv`` holds a sample); a
per-layer metric is ``metrics/<name>.py`` (its layer, source, the
end-to-end metric it moves, and ``read(readings)``). ``BENCHMARK.json``
says which end-to-end and per-layer metrics a cell reports. Adding a cell,
a configuration, a mix or a metric adds files and entries; no file here
changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return load_json(path)


def load_cell(name: str, base: Path = HERE) -> dict:
    """The cell's file, with its configuration and traffic mix loaded."""
    cell = load_json(base / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_file"] = load_json(base / "configs" / f"{cell['config']}.json")
    cell["traffic_file"] = load_json(base / "traffic"
                                     / f"{cell['traffic']}.json")
    return cell


def load_metric(name: str, base: Path = HERE):
    """The module of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def window_path(name: str):
    """The module of ``paths/<name>.py``: its ``run(Run) -> Outcome``."""
    return importlib.import_module(f"portbench.paths.{name}")


def end_to_end_of(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics ``cell`` reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_of(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics ``cell`` reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


@dataclass
class Run:
    """What a window path is given."""
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float          # the process's first clock reading
    log: Callable[[str], None] = print
    # What a path keeps for a study of its comparison's readings
    # (``portbench.study``): the reference's inputs and results.
    kept: dict = field(default_factory=dict)

    @property
    def settings(self) -> dict:
        return self.cell["config_file"]["settings"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic_file"]

    @property
    def limits(self) -> dict:
        return self.cell["limits"]


@dataclass
class Outcome:
    """What a window path returns: its end-to-end values, the counts of
    the work attempted and failed, the numbers compared with their
    limits, the device's peak memory, and the readings the per-layer
    metrics read in a traced run."""
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    compared: Dict[str, dict]
    memory_peak_bytes: int
    readings: Any = None
    trace: Any = None

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.compared.values())


def limit_entry(name: str, value: float, limit: float) -> tuple:
    """One number compared: it passes at or under its limit (a number
    that is not finite fails)."""
    value = float(value)
    if value != value or value in (float("inf"), float("-inf")):
        value = float("inf")
    return name, {"value": value, "limit": float(limit)}


def result_line(bench: dict, cell: dict, outcome: Outcome, trace: bool,
                device_kind: str, count: int) -> dict:
    """The result's JSON object: with ``trace`` false the cell's
    end-to-end metrics, else its per-layer metrics read from the traced
    run. Raises where a metric the cell reports has no value."""
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    metrics: Dict[str, dict] = {}
    if trace:
        for m in per_layer_of(bench, cell["name"]):
            value = load_metric(m["name"]).read(outcome.readings)
            if value is None:
                raise RuntimeError(f"per-layer metric {m['name']} found "
                                   f"nothing to read in {cell['name']}")
            metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in end_to_end_of(bench, cell["name"]):
            if m["name"] not in outcome.end_to_end:
                raise RuntimeError(f"{cell['name']} gave no {m['name']}")
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": outcome.correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device}
    if trace:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["compared"] = outcome.compared
    return line


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    """Wait for the device's queued work (nothing on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def reset_peak(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
