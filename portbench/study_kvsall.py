"""The readings the 1-N cell's limits are set from, on the card.

    python3 -m portbench.study_kvsall --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 1] [--out FILE]

As ``portbench.study`` for the cells of ``paths/train_kvsall.py``: for
each seed a run of the cell with a short window and the numbers its
comparison gave (the lower readings); for each control seed, from the
same inputs, the reference with TF32 on in cuBLAS and cuDNN in the
program's place (the control) and the faults planted in it: half of each
batch's queries left out, a step that returns its state unchanged
(``train_kvsall.study_readings``). One JSON line a reading, also appended
to ``--out``. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness
from .paths import train_kvsall
from .paths.common import leaf_norm_gaps, moving_leaves
from .reference.rgcn import leaves as ref_leaves


def worst_leaves(kept: dict, n: int = 4) -> dict:
    """The ``n`` leaves with the largest gaps of the first gradient's norm
    and of the change's norm (``common.leaf_norm_gaps``), each with its
    reference norms: where a worst-leaf number comes from."""
    got, want = kept["got"], kept["want"]
    start = ref_leaves(kept["params0"])
    keep = moving_leaves(want["first_grads"])
    out = {}
    for what, g, w in (
            ("grad", got["first_grads"], want["first_grads"]),
            ("change", {k: p - start[k] for k, p in got["params"].items()},
             {k: p - start[k] for k, p in want["params"].items()})):
        names = [k for k in w if keep[k]]
        gaps = leaf_norm_gaps(g, w, keep)
        top = sorted(zip(gaps, names), reverse=True)[:n]
        out[what] = [[k, gap, float(w[k].double().norm())]
                     for gap, k in top]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    p.add_argument("--leaves", action="store_true",
                   help="also print the worst leaves of each comparison")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card is attached", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = harness.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, args.seconds, False, device, t0,
                          lambda _: None)
        outcome = train_kvsall.run(run)
        lines = [{"cell": args.workload, "seed": seed, "kind": "program",
                  "readings": {k: c["value"]
                               for k, c in outcome.compared.items()},
                  "end_to_end": outcome.end_to_end}]
        for at, kept in sorted(run.kept.items()):
            if args.leaves:
                lines.append({"cell": args.workload, "seed": seed,
                              "kind": "leaves", "at": at,
                              "readings": worst_leaves(kept)})
            if seed in controls:
                for what, numbers in train_kvsall.study_readings(
                        kept).items():
                    lines.append({"cell": args.workload, "seed": seed,
                                  "kind": what, "at": at, "readings": {
                                      train_kvsall.prefix(at) + k:
                                      c["value"]
                                      for k, c in numbers.items()}})
        for ln in lines:
            ln["s"] = time.perf_counter() - t0
            text = json.dumps(ln)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
        del run, outcome
        train_kvsall.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
