"""A cell's run on the CPU at the toy graph (16 entities, 9 relations, 43
train edges drawn from the Toy dataset's 10 held-out triples, the
published widths): everything a run does but the look for a card."""
import time

import torch

from portbench import harness


def toy_cell(name: str) -> dict:
    cell = harness.load_cell(name)
    cell["traffic_file"] = dict(cell["traffic_file"], sample="toy",
                                n_entities=16, n_relations=9, n_train=43)
    return cell


def toy_run(name: str, seed: int = 7, seconds: float = 1.0):
    """(Outcome, Run) of cell ``name`` on the CPU at the toy graph. The
    window is long enough to hold a step on a loaded machine (the loop
    checks the clock before each step)."""
    cell = toy_cell(name)
    run = harness.Run(cell, seed, seconds, False, torch.device("cpu"),
                      time.perf_counter(), lambda _: None)
    path = harness.window_path(cell["traffic_file"]["path"])
    return path.run(run), run
