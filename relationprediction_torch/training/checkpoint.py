"""Read the JAX package's checkpoints (``RPTPUCK1``) without JAX.

Format (``relationprediction_tpu/training/checkpoint.py``): a fixed header
``RPTPUCK1<version:u32><crc32:u32>`` followed by a pickled state dict whose
arrays are numpy. Its ``opt_state`` holds optax NamedTuples, so a plain
``pickle.loads`` would import optax and, with it, JAX. The unpickler here
resolves only numpy and a few builtins; every other class becomes an inert
placeholder that keeps its arguments. ``params`` and ``step`` come back
intact. Like any pickle-based format, this is for checkpoints you wrote.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import zlib
from typing import Any, Dict, Optional

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
