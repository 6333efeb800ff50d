"""Train-state checkpoints in the JAX package's format (``RPTPUCK1``).

Format (``relationprediction_tpu/training/checkpoint.py:38-63``): a fixed
header ``RPTPUCK1<version:u32><crc32:u32>`` followed by a pickled state
dict, written as ``<path>-<step>.ckpt`` with the newest file's name in
``<path>.latest``. Top-level keys: ``schema_version``, ``params`` (the JAX
package's tree, numpy), ``opt_state``, ``step``, ``rng_key``,
``host_rng_state`` and ``extra``.

``save`` pickles numpy arrays and builtins only, never a torch object, so
the JAX package's plain ``restore`` reads a port checkpoint without
importing torch. A JAX checkpoint's ``opt_state`` holds optax NamedTuples,
so a plain ``pickle.loads`` would import optax and, with it, JAX. The
unpickler here resolves only numpy and a few builtins; every other class
becomes an inert placeholder that keeps its arguments
(``optimizers.opt_state_from_jax`` reads them). Like any pickle-based
format, this is for checkpoints you wrote.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import zlib
from typing import Any, Dict, Optional

import numpy as np

_MAGIC = b"RPTPUCK1"
_VERSION = 1
_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "range", "set", "slice", "str", "tuple"})


class Placeholder:
    """Stands in for a class the restricted unpickler will not import."""

    _qualname = "?"

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __setstate__(self, state):
        self.state = state

    def __repr__(self) -> str:
        return f"<placeholder {self._qualname} {self.args!r}>"


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        return type(name, (Placeholder,), {"_qualname": f"{module}.{name}"})


def save(path: str, *, params, opt_state, step: int, rng_key,
         host_rng_state: Optional[Dict[str, Any]] = None,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Write checkpoint ``<path>-<step>.ckpt`` and update ``<path>.latest``.

    Every array must already be numpy (``params.params_to_numpy``); a
    torch tensor anywhere in the state raises TypeError."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fname = f"{path}-{step}.ckpt"
    state = {
        "schema_version": _VERSION,
        "params": params,
        "opt_state": opt_state,
        "step": int(step),
        "rng_key": np.asarray(rng_key),
        "host_rng_state": host_rng_state,
        "extra": extra or {},
    }
    _check_plain(state)
    payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    header = _MAGIC + struct.pack("<II", _VERSION,
                                  zlib.crc32(payload) & 0xFFFFFFFF)
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(payload)
    os.replace(tmp, fname)
    with open(path + ".latest", "w") as f:
        f.write(os.path.basename(fname))
    return fname


def _check_plain(tree) -> None:
    """Raise TypeError unless ``tree`` holds only numpy and builtins."""
    if isinstance(tree, dict):
        for v in tree.values():
            _check_plain(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _check_plain(v)
    elif not (tree is None or isinstance(tree, (np.ndarray, np.generic,
                                                bool, int, float, str,
                                                bytes))):
        raise TypeError(f"checkpoint state holds a {type(tree)!r}; save "
                        f"numpy arrays and builtins only")


def restore(fname: str) -> Dict[str, Any]:
    """The checkpoint's state dict; ``opt_state`` and any non-numpy class
    inside it come back as placeholders."""
    with open(fname, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        raise ValueError(f"{fname}: not a relationprediction checkpoint "
                         f"(bad magic)")
    version, crc = struct.unpack("<II", blob[len(_MAGIC):len(_MAGIC) + 8])
    if version != _VERSION:
        raise ValueError(f"{fname}: checkpoint schema version {version} "
                         f"!= supported {_VERSION}")
    payload = blob[len(_MAGIC) + 8:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ValueError(f"{fname}: checksum mismatch (corrupt/truncated "
                         f"checkpoint)")
    return _RestrictedUnpickler(io.BytesIO(payload)).load()


def latest_path(path: str) -> Optional[str]:
    marker = path + ".latest"
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    full = os.path.join(os.path.dirname(os.path.abspath(path)), name)
    return full if os.path.exists(full) else None


def restore_latest(path: str) -> Optional[Dict[str, Any]]:
    """The newest checkpoint written under the prefix ``path``, or None."""
    p = latest_path(path)
    return restore(p) if p else None
