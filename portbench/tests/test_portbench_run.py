"""The entry point: no result without a card, none in a directory that
holds only the benchmark, and the per-layer readers on a CPU run's
readings."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from portbench import harness, run
from portbench.tests.toy import toy_run

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "rgcn_block.fb15k237.train", "--seed", "1",
        "--seconds", "1"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", *ARGS],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "relationprediction_tpu_extra", None)
    assert run.loaded_forbidden() == [] or "jax" in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "flax.core", None)
    assert "flax" in run.loaded_forbidden()


def test_untraced_line_and_readers_on_cpu_readings():
    bench = harness.load_benchmark()
    outcome, r = toy_run("rgcn_block.fb15k237.train")
    cell = r.cell
    line = harness.result_line(bench, cell, outcome, False, "cpu", 1)
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"train_triples_per_s", "setup_s"}
    json.dumps(line)
    # counters and rates read from an untraced run; the device's readers
    # find nothing on the CPU
    for name, want in (("batch_wait_ms.train", True),
                       ("host_batch_ms.train", True),
                       ("train_mfu", True),
                       ("device_step_ms.train", False),
                       ("device_idle_share.train", False),
                       ("block_direction_roofline.train", False)):
        got = harness.load_metric(name).read(outcome.readings)
        assert (got is not None) == want, name
        assert got is None or got > 0
