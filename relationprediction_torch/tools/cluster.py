"""Visualize learned per-relation basis coefficients.

Counterpart of ``code/tools/cluster.py`` (which plots relation coefficient
vectors in 3-D and optionally k-means clusters them). Reads coefficients
either from a TSV dump or directly from a checkpoint, the port's or the
JAX package's (``training/checkpoint.restore_latest``). ``plot`` needs
matplotlib (and, to cluster, scikit-learn), imported when it runs.

    python -m relationprediction_torch.tools.cluster --checkpoint models/X \
        --layer 0 --out coeffs.png

The port's copy of ``relationprediction_tpu/tools/cluster.py``.
"""
from __future__ import annotations

import argparse

import numpy as np


def load_coefficients_tsv(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            rows.append([float(x) for x in line.strip().split("\t")])
    return np.asarray(rows)


def load_coefficients_checkpoint(path: str, layer: int = 0,
                                 direction: str = "forward") -> np.ndarray:
    from ..training import checkpoint
    state = checkpoint.restore_latest(path)
    if state is None:
        raise FileNotFoundError(f"no checkpoint at {path}")
    layer_params = state["params"]["gcn_layers"][layer]
    return np.asarray(layer_params[f"C_{direction}"])


def plot(coeffs: np.ndarray, out: str, n_clusters: int = 0) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = coeffs.reshape(coeffs.shape[0], -1)
    fig = plt.figure(figsize=(8, 6))
    if x.shape[1] >= 3:
        ax = fig.add_subplot(projection="3d")
        args = (x[:, 0], x[:, 1], x[:, 2])
    else:
        ax = fig.add_subplot()
        args = (x[:, 0], x[:, 1] if x.shape[1] > 1 else np.zeros(len(x)))

    colors = None
    if n_clusters > 1:
        try:
            from sklearn.cluster import KMeans
            colors = KMeans(n_clusters=n_clusters,
                            n_init=10).fit_predict(x)
        except ImportError:
            pass
    ax.scatter(*args, c=colors, marker=".")
    ax.set_title("Per-relation basis coefficients")
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Plot learned relation coefficient vectors.")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--tsv", help="TSV dump of coefficient rows.")
    group.add_argument("--checkpoint", help="Framework checkpoint path.")
    parser.add_argument("--layer", type=int, default=0)
    parser.add_argument("--direction", default="forward",
                        choices=["forward", "backward"])
    parser.add_argument("--clusters", type=int, default=0)
    parser.add_argument("--out", default="coefficients.png")
    args = parser.parse_args(argv)

    if args.tsv:
        coeffs = load_coefficients_tsv(args.tsv)
    else:
        coeffs = load_coefficients_checkpoint(args.checkpoint, args.layer,
                                              args.direction)
    plot(coeffs, args.out, args.clusters)


if __name__ == "__main__":
    main()
