"""Ensemble combination of model score dumps — the "R-GCN+" mechanism.

Functional port-surface of ``code/tools/ensemble.py``: combine two trained
models' dumped predictions (from ``Scorer.dump_all_scores`` /
``MrrSummary.dump_degrees``) either by a per-vertex degree cutoff or a
weighted score sum, and report MRR / Hits@k of the combination. This is how
the paper's R-GCN+ = ensemble(R-GCN, DistMult) numbers are produced.

Usage:
    python -m relationprediction_torch.tools.ensemble \
        --p1 dumps/rgcn --p2 dumps/distmult --method weighted_sum

The port's copy of ``relationprediction_tpu/tools/ensemble.py``.
"""
from __future__ import annotations

import argparse
from typing import Iterator, List, Tuple

import numpy as np


def read_degree_file(filename: str) -> List[Tuple[int, float]]:
    """Lines of ``degree\tmrr`` (MrrSummary.dump_degrees output)."""
    out = []
    with open(filename) as f:
        for line in f:
            degree, mrr = line.strip().split("\t")
            out.append((int(degree), float(mrr)))
    return out


def read_score_file(filename: str) -> Iterator[Tuple[float, np.ndarray]]:
    """Lines of ``target | s1\ts2\t...`` (Scorer.dump_all_scores output)."""
    with open(filename) as f:
        for line in f:
            parts = line.strip().split(" | ")
            target = float(parts[0])
            others = (np.array([float(p) for p in parts[1].split("\t")])
                      if len(parts) > 1 and parts[1] else np.array([]))
            yield target, others


class CutoffEnsemble:
    """Pick model_1's per-triple MRR for low-degree vertices, model_2's for
    high-degree (degree >= cutoff) — the paper's degree-routed ensemble."""

    def __init__(self, cutoff: int, model_1: str, model_2: str):
        self.cutoff = cutoff
        self.model_1 = model_1
        self.model_2 = model_2

    def combine(self) -> np.ndarray:
        """[2N] per-triple MRRs, interleaved (in, out) per triple, each
        routed by the triple's total degree."""
        def load(model):
            # columns: degree, per-triple mrr — for both prediction sides
            d_in = np.asarray(read_degree_file(model + "/degrees.in"))
            d_out = np.asarray(read_degree_file(model + "/degrees.out"))
            return d_in, d_out

        (a_in, a_out), (b_in, b_out) = load(self.model_1), load(self.model_2)
        total_degree = a_in[:, 0] + a_out[:, 0]
        use_low = total_degree < self.cutoff
        # stack (in, out) mrr columns -> [N, 2], route whole rows, flatten
        low = np.stack([a_in[:, 1], a_out[:, 1]], axis=1)
        high = np.stack([b_in[:, 1], b_out[:, 1]], axis=1)
        return np.where(use_low[:, None], low, high).reshape(-1)

    def compute_ranks(self) -> None:
        self.mrrs = self.combine()

    def combined_mrr(self) -> float:
        return float(np.mean(self.mrrs))

    def hits_at(self, threshold: int) -> float:
        # Per-triple MRRs, not ranks: a hit@k is mrr >= 1/k.
        return float(np.mean(self.mrrs >= 1.0 / threshold))


class WeightEnsemble:
    """Rank from the weighted sum of both models' candidate scores."""

    def __init__(self, weight: float, model_1: str, model_2: str):
        self.weight = weight
        self.model_1 = model_1
        self.model_2 = model_2

    def combine(self) -> Iterator[int]:
        for side in ("subjects.test", "objects.test"):
            for left, right in zip(
                    read_score_file(f"{self.model_1}/{side}"),
                    read_score_file(f"{self.model_2}/{side}")):
                yield self.combine_prediction(left, right)

    def combine_prediction(self, left, right) -> int:
        w = self.weight
        target = w * left[0] + (1 - w) * right[0]
        others = w * np.asarray(left[1]) + (1 - w) * np.asarray(right[1])
        return int(np.sum(others >= target)) + 1

    def compute_ranks(self) -> None:
        self.ranks = np.array(list(self.combine()))

    def combined_mrr(self) -> float:
        return float(np.mean(1.0 / self.ranks))

    def hits_at(self, threshold: int) -> float:
        return float(np.mean(self.ranks <= threshold))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Combine the output of multiple runs in an ensemble.")
    parser.add_argument("--p1", required=True)
    parser.add_argument("--p2", required=True)
    parser.add_argument("--method", required=True,
                        choices=["cutoff", "weighted_sum"])
    parser.add_argument("--cutoff", type=int, default=1000)
    parser.add_argument("--weight", type=float, default=0.5)
    args = parser.parse_args(argv)

    if args.method == "cutoff":
        model = CutoffEnsemble(args.cutoff, args.p1, args.p2)
    else:
        model = WeightEnsemble(args.weight, args.p1, args.p2)

    model.compute_ranks()
    print(model.combined_mrr())
    print(model.hits_at(1))
    print(model.hits_at(3))
    print(model.hits_at(10))


if __name__ == "__main__":
    main()
