"""How long a step of the window waited for its batch: the mean of
``FitResult.steps[*].wait_ms`` (the fit loop's host clock around taking
the next batch from the prefetching producers) over the steps the
profiler left alone."""
from portbench.trace import quiet_steps

LAYER = "host batch"
SOURCE = "program_span"
MOVES = "train_triples_per_s"
UNIT = "ms"


def read(r):
    steps = quiet_steps(r)
    if r.kind != "train" or not steps:
        return None
    return sum(s["wait_ms"] for s in steps) / len(steps)
