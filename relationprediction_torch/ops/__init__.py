"""Kernels and their plain PyTorch versions.

A kernel's wrapper counts its launches in integer attributes, named to end
in ``launches``, of a module-level function of this package
(``staircase2.block_direction.twin_launches``, ...)."""
import inspect
import sys


def launch_counters() -> dict:
    """Every kernel launch counter now, (function, attribute) -> count: each
    attribute ending in ``launches`` of a function defined in a loaded
    module of this package."""
    prefix = __name__ + "."
    counts = {}
    for name, module in list(sys.modules.items()):
        if module is None or not name.startswith(prefix):
            continue
        for fn in vars(module).values():
            if inspect.isfunction(fn) and fn.__module__ == name:
                counts.update(((fn, attr), n) for attr, n in vars(fn).items()
                              if attr.endswith("launches"))
    return counts


def add_launches(counts: dict) -> None:
    """Add ``counts`` ((function, attribute) -> n, as ``launch_counters``
    keys them) to the counters."""
    for (fn, attr), n in counts.items():
        setattr(fn, attr, getattr(fn, attr) + n)
