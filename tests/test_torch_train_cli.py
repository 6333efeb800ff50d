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


def small_copy(tmp_path, name):
    """settings/<name>.exp with CheckEvery=5, BurninPhaseDuration=10 and
    ReportTrainLossEvery=5, saving under tmp_path; the published widths
    (d=500) stay: data/Toy has 16 entities."""
    src = (ROOT / "settings" / f"{name}.exp").read_text()
    for a, b in (("CheckEvery=2000", "CheckEvery=5"),
                 ("BurninPhaseDuration=6000", "BurninPhaseDuration=10"),
                 ("ReportTrainLossEvery=100", "ReportTrainLossEvery=5")):
        assert a in src
        src = src.replace(a, b)
    src = re.sub(r"ExperimentName=\S+", f"ExperimentName={tmp_path / 'm'}",
                 src)
    path = tmp_path / f"{name}.exp"
    path.write_text(src)
    return str(path)


@pytest.mark.parametrize("name", ["gcn_block", "gcn_basis", "distmult",
                                  "complex"])
def test_train_cli_stops_early_saves_resumes_and_evaluates(tmp_path, capsys,
                                                           name):
    """Without --max-iterations the CLI trains until the early stopper
    fires; the newest checkpoint is read by the JAX package's restore and
    by the port's evaluate CLI, and --resume continues from it (capped
    100 steps past the first stop)."""
    from relationprediction_tpu.training import checkpoint as jax_ckpt
    from relationprediction_torch import evaluate as torch_evaluate
    args = ["--settings", small_copy(tmp_path, name),
            "--dataset", str(ROOT / "data" / "Toy"), "--cpu"]
    torch_train.main(args)
    out = capsys.readouterr().out
    done = re.search(r"Training done: (\d+) iterations .*\(early stop: "
                     r"True\)", out)
    assert done, out
    stop = int(done.group(1))
    assert stop % 5 == 0 and stop > 10
    assert f"Tested validation score at iteration {stop}." in out
    assert "Stopping criterion reached." in out
    saved = jax_ckpt.restore_latest(str(tmp_path / "m"))
    assert saved["step"] == stop - 5
    assert out.count("saving...") == stop // 5 - 1

    torch_evaluate.main(args + ["--split", "valid"])
    out = capsys.readouterr().out
    assert f"(step {stop - 5})" in out and "MRR" in out

    torch_train.main(args + ["--resume", "--max-iterations",
                             str(stop + 100)])
    out = capsys.readouterr().out
    resumed = re.search(r"Training done: (\d+) iterations", out)
    assert resumed, out
    assert int(resumed.group(1)) > stop - 5
    assert "Initial loss" not in out  # the run continues at step stop - 4
    assert f"Tested validation score at iteration {stop}." in out


@pytest.mark.parametrize("mode", ["split", "shared"])
def test_train_cli_trains_the_split_and_shared_modes(capsys, monkeypatch,
                                                     mode):
    """--negative-mode split and shared train on the CPU and print the
    final test metrics; without --cpu and without a card they raise."""
    torch_train.main(ARGS + ["--cpu", "--negative-mode", mode,
                             "--max-iterations", "2"])
    out = capsys.readouterr().out
    initial = re.search(r"Initial loss: (\S+)", out)
    assert initial and math.isfinite(float(initial.group(1))), out
    assert re.search(r"Training done: 2 iterations", out), out
    assert "Final test metrics:" in out and "MRR" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_train.main(ARGS + ["--negative-mode", mode,
                                 "--max-iterations", "1"])
