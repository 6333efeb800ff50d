"""On the card: one short run of every cell through the entry point, its
result line, and a second run that finds every kernel built."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_cell(cell, seed, trace):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(seed), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    first = run_cell(cell, 2 ** 31 + 11, 0)
    second = run_cell(cell, 2 ** 31 + 12, 1)
    assert first["correct"] and second["correct"]
    assert first["device"]["platform"] == "gpu"
    assert 0 < second["device"]["busy_s"] <= second["device"]["window_s"]
    assert list(second)[-1] == "compared"
