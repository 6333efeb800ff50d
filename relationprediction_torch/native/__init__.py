"""The host sampler in C++ (``sampler.cpp``), bound with ctypes.

Counterpart of ``relationprediction_tpu/native/__init__.py``, with the port's
own copy of the source: the degree-weighted neighbourhood sampler, which
gives the same edge ids as the JAX package's for the same seed. At first use
``g++ -O3 -shared -fPIC`` builds it into ``build/torch_kernels/`` at the root
of the checkout, named by the hash of the source and the flags. Where no
``g++`` is found, ``available()`` is false and ``sampling`` takes its numpy
version, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops.nvcc import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "sampler.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
# The batch producer threads reach get_lib together on a fresh checkout;
# one of them builds while the others wait (they would share one temporary
# file name, which is per process).
_BUILD_LOCK = threading.Lock()


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return str(BUILD_DIR / f"sampler-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, path)
    return True


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the library; None without a g++."""
    path = library_path()
    with _BUILD_LOCK:
        if not os.path.exists(path) and not _build(path):
            return None
    lib = ctypes.CDLL(path)
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.sample_edge_neighborhood.restype = ctypes.c_int
    lib.sample_edge_neighborhood.argtypes = [
        i32, i32, i64, i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, i32]
    return lib


def available() -> bool:
    return get_lib() is not None


def sample_edge_neighborhood(adj, sample_size: int, seed: int) -> np.ndarray:
    """Degree-weighted neighbourhood sampling over a
    ``sampling.AdjacencyIndex``. Raises if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native sampler unavailable (no g++)")
    out = np.empty(sample_size, dtype=np.int32)
    rc = lib.sample_edge_neighborhood(
        np.ascontiguousarray(adj.sorted_edges, dtype=np.int32),
        np.ascontiguousarray(adj.sorted_others, dtype=np.int32),
        np.ascontiguousarray(adj.offsets, dtype=np.int64),
        np.ascontiguousarray(adj.degrees, dtype=np.int64),
        adj.n_entities, adj.n_edges, sample_size, seed, out)
    if rc != 0:
        raise RuntimeError(f"native sampler failed (rc={rc}): "
                           f"sample_size {sample_size} > available edges?")
    return out
