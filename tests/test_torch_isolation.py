"""The port stands alone: no JAX, no JAX package, and no silent CPU runs."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import jax  # noqa: F401  (the test process holds both packages)
import pytest
import torch

from relationprediction_torch import device as device_lib
from relationprediction_torch import evaluate as torch_evaluate
from relationprediction_torch import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "relationprediction_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "relationprediction_tpu"}


def port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_the_jax_package():
    files = port_files()
    assert len(files) > 10
    for path in files:
        bad = imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_port_module_leaves_jax_out():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    script = ("import importlib, sys\n"
              f"for m in {modules!r}: importlib.import_module(m)\n"
              "import chip_smoke\n"
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              f"{sorted(FORBIDDEN)!r}]\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_native_sampler_is_the_ports_own():
    """The C++ sampler builds from the port's copy into build/ and the
    process maps no file from under relationprediction_tpu/."""
    assert (PORT / "native" / "__init__.py") in port_files()
    assert pathlib.Path(native.SOURCE).parent == PORT / "native"
    assert pathlib.Path(native.library_path()).parent == \
        ROOT / "build" / "torch_kernels"
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native sampler")
    script = ("import numpy as np\n"
              "from relationprediction_torch import native, sampling\n"
              "tri = np.array([[0, 0, 1], [1, 0, 2], [2, 1, 0]])\n"
              "adj = sampling.AdjacencyIndex(tri, 3)\n"
              "assert sorted(native.sample_edge_neighborhood(adj, 3, 1)) "
              "== [0, 1, 2]\n"
              "maps = open('/proc/self/maps').read()\n"
              "assert native.library_path() in maps\n"
              "assert 'relationprediction_tpu' not in maps\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_resolve_device_never_falls_back(monkeypatch):
    assert device_lib.resolve_device(cpu=True) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve_device(cpu=False)


def test_evaluate_cli_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_evaluate.main(["--settings",
                             str(ROOT / "settings" / "gcn_block.exp"),
                             "--dataset", str(ROOT / "data" / "Toy")])


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
