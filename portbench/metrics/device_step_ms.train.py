"""The device step: the mean of ``FitResult.steps[*].step_ms`` over the
steps the profiler left alone, the program's CUDA events around draws, encode, loss, backward, clipping and
Adam."""
from portbench.trace import quiet_steps

LAYER = "train step"
SOURCE = "program_span"
MOVES = "train_triples_per_s"
UNIT = "ms"


def read(r):
    steps = quiet_steps(r)
    if r.kind != "train" or not steps \
            or any(s["step_ms"] is None for s in steps):
        return None
    return sum(s["step_ms"] for s in steps) / len(steps)
