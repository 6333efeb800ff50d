"""The port's train CLI end to end on data/Toy, on the CPU."""
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from relationprediction_torch import train as torch_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--settings", str(ROOT / "settings" / "gcn_block.exp"),
        "--dataset", str(ROOT / "data" / "Toy")]


def test_train_cli_on_cpu_prints_finite_losses_without_jax():
    script = ("import sys\n"
              "from relationprediction_torch import train\n"
              f"train.main({ARGS + ['--cpu', '--max-iterations', '3']!r})\n"
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'relationprediction_tpu')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    initial = re.search(r"Initial loss: (\S+)", out)
    last = re.search(r"Training done: 3 iterations .* last loss (\S+)", out)
    assert initial and last, out
    assert math.isfinite(float(initial.group(1)))
    assert math.isfinite(float(last.group(1)))
    assert "Final test metrics:" in out and "MRR" in out


def test_train_cli_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_train.main(ARGS + ["--max-iterations", "1"])
