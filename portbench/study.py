"""The readings a cell's limits are set from, on the card.

    python3 -m portbench.study --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 1] [--out FILE]

For each seed: a run of the cell with a short window, and the numbers its
comparison gave (the program against the reference: the lower readings).
For each control seed, in the same process from the same inputs: the
control, the reference computed with TF32 products in the program's place
(the upper readings); for a training cell also the faults a training step
can have, planted in the reference put in the program's place: half of
each batch left out (the mean taken over the rest) and a step that returns
its state unchanged. One JSON line a reading, also appended to ``--out``.
The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness
from .paths import train as train_path
from .reference import rgcn as ref


def half_batch(steps: list) -> list:
    """Each step with the first half of its positives and their
    corruptions alone."""
    out = []
    for s in steps:
        n = s["positives"].shape[0] // 2
        out.append({**s, "positives": s["positives"][:n],
                    "neg_values": s["neg_values"][:n],
                    "corrupt_object": s["corrupt_object"][:n]})
    return out


def leaf_table(kept: dict, control: bool) -> dict:
    """Each leaf's reference norm and the program's (and the control's),
    of the first gradient and of the change over the steps, and each
    step's loss on each side: where a worst-leaf number comes from."""
    want, start = kept["want"], ref.leaves(kept["params0"])
    sides = [want, kept["got"]]
    if control:
        sides.append(ref.train_steps(kept["params0"], kept["steps"],
                                     kept["spec"], kept["n_vertices"],
                                     tf32=True, state=kept["state"]))
    out = {"losses": [s["losses"] for s in sides]}
    for k in want["first_grads"]:
        out[k] = [[float(s["first_grads"][k].double().norm())
                   for s in sides],
                  [float((s["params"][k] - start[k]).double().norm())
                   for s in sides]]
    return out


def train_readings(kept: dict) -> dict:
    """The numbers of ``compare`` for one run of checked steps, with the
    control and each fault put in the program's place, from the same
    start."""
    spec, v, state = kept["spec"], kept["n_vertices"], kept["state"]
    want, params0 = kept["want"], kept["params0"]
    numbers = {}
    control = ref.train_steps(params0, kept["steps"], spec, v, tf32=True,
                              state=state)
    numbers["control"] = train_path.compare(control, want, params0)
    half = ref.train_steps(params0, half_batch(kept["steps"]), spec, v,
                           state=state)
    numbers["half_batch"] = train_path.compare(half, want, params0)
    unchanged = {"losses": want["losses"],
                 "first_grads": {k: torch.zeros_like(g)
                                 for k, g in want["first_grads"].items()},
                 "params": ref.leaves(params0)}
    numbers["unchanged_state"] = train_path.compare(unchanged, want, params0)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    p.add_argument("--leaves", action="store_true",
                   help="also print each leaf's norms (training cells)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card is attached", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = harness.load_cell(args.workload)
    path = harness.window_path(cell["traffic_file"]["path"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, args.seconds, False, device, t0,
                          lambda _: None)
        outcome = path.run(run)
        line = {"cell": args.workload, "seed": seed, "kind": "program",
                "readings": {k: c["value"]
                             for k, c in outcome.compared.items()},
                "end_to_end": outcome.end_to_end}
        lines = [line]
        for at, kept in sorted(run.kept.items()):
            if args.leaves:
                lines.append({"cell": args.workload, "seed": seed,
                              "kind": "leaves", "at": at,
                              "readings": leaf_table(kept, seed in controls)})
            line["readings"].update(
                (train_path.prefix(at) + k, c["value"]) for k, c in train_path.compare(
                    kept["got"], kept["want"], kept["params0"]).items())
            if seed in controls:
                for what, numbers in train_readings(kept).items():
                    lines.append({"cell": args.workload, "seed": seed,
                                  "kind": what, "at": at, "readings": {
                                      train_path.prefix(at) + k: c["value"]
                                      for k, c in numbers.items()}})
        for ln in lines:
            ln["s"] = time.perf_counter() - t0
            text = json.dumps(ln)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
        del run, outcome
        train_path.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
