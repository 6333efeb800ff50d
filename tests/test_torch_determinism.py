"""One seed gives one run: two fits with the same settings, data and seed
end with the same params and Adam state bit for bit, on the CPU at
PyTorch's default settings (no deterministic algorithms, the default
thread count, batches on 2 producer threads as train.py builds them).

Widths are cut to d = 100 so that each case takes seconds, yet the
gathers' cotangents exceed the 32,768 elements from which autograd's
index_put_ adds in parallel on the CPU (data/Toy's 43 positives x 10
corruptions x 100): at the parent of the fix these runs differed after
the first step."""
import os
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from relationprediction_torch import config as torch_config
from relationprediction_torch import native
from relationprediction_torch.data import dataset as torch_dataset
from relationprediction_torch.models.build import build_model
from relationprediction_torch.params import tree_leaves
from relationprediction_torch.training import checkpoint
from relationprediction_torch.training.engine import TrainLoop

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOY = ROOT / "data" / "Toy"
WIDTH = 100
STEPS = 20
SETTINGS = ("gcn_block", "gcn_basis", "distmult")
# Runs train.py's main in a fresh process and checks that nothing turned
# on deterministic algorithms on the way.
CHILD = ("import sys, torch\n"
         "from relationprediction_torch import train\n"
         "train.main(sys.argv[1:])\n"
         "assert not torch.are_deterministic_algorithms_enabled()\n")


def narrowed(name: str, out: pathlib.Path) -> pathlib.Path:
    """settings/<name>.exp at d = WIDTH (gcn_block: 20 blocks of 5), one
    check at STEPS inside the burn-in (so a checkpoint is saved there),
    saving under ``out``."""
    src = (ROOT / "settings" / f"{name}.exp").read_text()
    for key, value in (("CodeDimension", WIDTH),
                       ("InternalEncoderDimension", WIDTH),
                       ("CheckEvery", STEPS),
                       ("BurninPhaseDuration", 10 * STEPS)):
        src, n = re.subn(rf"{key}=\d+", f"{key}={value}", src)
        assert n <= 1, key
    if name == "gcn_block":
        src = re.sub(r"NumberOfBasisFunctions=\d+",
                     f"NumberOfBasisFunctions={WIDTH // 5}", src)
    src = re.sub(r"ExperimentName=\S+", f"ExperimentName={out / 'm'}", src)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.exp"
    path.write_text(src)
    return path


@pytest.mark.parametrize("name", SETTINGS)
def test_two_train_cli_runs_give_the_same_checkpoint(tmp_path, name):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    blobs, arrays = [], []
    for run in ("a", "b"):
        settings = narrowed(name, tmp_path / run)
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, "--settings", str(settings),
             "--dataset", str(TOY), "--cpu", "--max-iterations",
             str(STEPS), "--seed", "3"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        path = tmp_path / run / f"m-{STEPS}.ckpt"
        blobs.append(path.read_bytes())
        arrays.append(checkpoint.restore(str(path)))
    a, b = arrays
    assert a["step"] == b["step"] == STEPS
    for part in ("params", "opt_state"):
        for x, y in zip(tree_leaves(a[part]), tree_leaves(b[part])):
            np.testing.assert_array_equal(x, y)
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("name", SETTINGS)
def test_two_fits_in_one_process_give_the_same_params(tmp_path, name):
    cfg = torch_config.load(str(narrowed(name, tmp_path)))
    ds = torch_dataset.load(str(TOY))
    cfg = cfg.with_counts(ds.n_entities, ds.n_relations, len(ds.train))
    model = build_model(cfg, torch.device("cpu"))
    results = []
    for _ in range(2):
        loop = TrainLoop(model, cfg, ds, seed=5, log=lambda line: None)
        results.append(loop.fit(max_iterations=STEPS))
    a, b = results
    assert [s["loss"] for s in a.steps] == [s["loss"] for s in b.steps]
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt_state),
                    tree_leaves(b.params) + tree_leaves(b.opt_state)):
        assert torch.equal(x, y)
    assert not torch.are_deterministic_algorithms_enabled()



def test_batch_producers_build_the_sampler_once(tmp_path, monkeypatch):
    """A fit on a fresh checkout: its producer threads reach the native
    sampler's first build together; one builds it, the others wait and
    load the same library (they once raced on one temporary file)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.get_lib.cache_clear()
    errors = []

    def load():
        try:
            assert native.available()
        except Exception as err:  # reported below, with every thread's
            errors.append(err)
    try:
        threads = [threading.Thread(target=load) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        native.get_lib.cache_clear()
    assert errors == []
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
