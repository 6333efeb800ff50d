"""What a batch costs the host: the mean of ``FitResult.steps[*].batch_ms``
over the steps the profiler left alone (the producer thread's host clock around sampling, the split, the four
CSRs and the copy's enqueue)."""
from portbench.trace import quiet_steps

LAYER = "host batch"
SOURCE = "program_span"
MOVES = "train_triples_per_s"
UNIT = "ms"


def read(r):
    steps = quiet_steps(r)
    if r.kind != "train" or not steps:
        return None
    return sum(s["batch_ms"] for s in steps) / len(steps)
