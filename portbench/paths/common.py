"""What the window paths share: the port's configuration from a
configuration file, the seeded dataset, the comparison of two trees by
leaf."""
from __future__ import annotations

import statistics

import torch

from .. import graphs
from ..reference import rgcn as ref


def port_config(settings: dict):
    """The port's ``RunConfig`` of a configuration file's settings tree,
    through the port's own .exp reader."""
    from relationprediction_torch import config as config_lib

    def tree(d: dict):
        s = config_lib.Settings()
        for k, v in d.items():
            s[k] = tree(v) if isinstance(v, dict) else str(v)
        return s
    return config_lib.from_settings(tree(settings))


def dataset(traffic: dict, seed: int):
    """The cell's graph (``portbench.graphs.draw``: the published counts
    drawn from the real held-out triples, the structure of
    ``structure_seed`` relabelled by ``seed``) as the port's dataset."""
    from relationprediction_torch.data.dataset import KGDataset
    g = graphs.draw(traffic, seed)
    return KGDataset(
        name=f"portbench-{traffic['sample']}",
        entities={i: f"e{i}" for i in range(g["n_entities"])},
        relations={i: f"r{i}" for i in range(g["n_relations"])},
        train=g["train"], valid=g["valid"], test=g["test"])


def leaf_norm_gaps(got: dict, want: dict, keep: dict) -> list:
    """Each leaf's gap between the norms of ``got`` and ``want`` (by leaf
    path), over the larger of that leaf's reference norm and the median
    leaf's; only the leaves ``keep`` marks."""
    norms = {k: float(want[k].double().norm()) for k in want}
    kept = [k for k in want if keep[k]]
    median = statistics.median(norms[k] for k in kept)
    return [abs(float(got[k].double().norm()) - norms[k])
            / max(norms[k], median) for k in kept]


def moving_leaves(first_grads: dict) -> dict:
    """The leaves whose first reference gradient is not nought to
    rounding: its norm at least a thousandth of the median leaf's (a
    leaf under it, such as the block and basis layers' bias, which the
    equations never add, moves under Adam by round-off alone)."""
    norms = {k: float(g.double().norm()) for k, g in first_grads.items()}
    median = statistics.median(norms.values())
    return {k: n >= 1e-3 * median for k, n in norms.items()}


def free_device() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def leaves(tree) -> dict:
    return ref.leaves(tree)


def set_up_line(t_start: float, marks: list) -> str:
    """Set-up's seconds, and each phase's: ``marks`` holds (phase, host
    clock at its end) from the process's start."""
    parts, last = [], t_start
    for name, t in marks:
        parts.append(f"{name} {t - last:.3f}")
        last = t
    return f"set-up {last - t_start:.3f} s: " + ", ".join(parts)


def quarters_line(t0: float, ends: list, seconds: float) -> str:
    """The steps (or passes) that ended in each quarter of the window, a
    look at how steady the pace held within it."""
    counts = [0, 0, 0, 0]
    for t in ends:
        counts[min(3, int(4 * (t - t0) / seconds))] += 1
    return "steps a quarter of the window: " + " ".join(map(str, counts))
