"""Build a CUDA source of ``ops/csrc`` into a shared library and load it.

Each source has a plain C interface and is bound with ``ctypes``: one
``nvcc`` call for ``sm_90a`` takes seconds, where a build that includes
PyTorch's headers takes minutes. Libraries go to ``build/torch_kernels/`` at
the root of the checkout, named by the hash of the source, the headers of
``ops/csrc`` and the flags (``source_digest``), so an edited source or
header is rebuilt at its first use and an unchanged one is not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    """What one build did: the library, its wall time (0 when an up-to-date
    library was found) and ptxas' per-kernel registers and spills."""

    path: Path
    seconds: float
    cached: bool
    ptxas: tuple

    def as_dict(self) -> dict:
        return {"library": str(self.path), "build_s": self.seconds,
                "cached": self.cached, "ptxas": list(self.ptxas)}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA toolkit is needed to build the port's kernels")


def ptxas_summary(log: str) -> tuple:
    """One line per compiled kernel: its registers and spill bytes."""
    out = []
    name, spills = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f", {m.group(1)} B spill stores, {m.group(2)} B " \
                     f"spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append(f"{name}: {m.group(1)} registers{spills}")
            name = None
    return tuple(out)


def source_digest(src: Path) -> str:
    """The name of a build of ``src``: a hash of its bytes, of every header
    (``*.cuh``) in its directory, which it may include, and of the
    flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(source: str) -> BuildInfo:
    """Compile ``csrc/<source>`` unless a library of the same hash exists."""
    src = CSRC / source
    lib = BUILD_DIR / f"{src.stem}-{source_digest(src)}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, True, ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, False,
                     ptxas_summary(proc.stdout + proc.stderr))


def load(source: str) -> tuple:
    """Build if needed and load: returns (ctypes.CDLL, BuildInfo)."""
    info = build(source)
    return ctypes.CDLL(str(info.path)), info
