"""Model FLOPs of a training step (``portbench.work.train_step_flops``:
the direct per-edge form, backward at twice the forward) over the mean
host-clock period of the steps the profiler left alone, times the card's
float32 peak, in %."""
from portbench import bounds, work
from portbench.trace import quiet_period

LAYER = "train step"
SOURCE = "host_clock"
MOVES = "train_triples_per_s"
UNIT = "%"


def read(r):
    period = quiet_period(r)
    if r.kind != "train" or period is None:
        return None
    flops = work.train_step_flops(r.shape, r.n_vertices, r.n_message_edges,
                                  r.n_positives, r.rate)
    return 100.0 * flops / (period * bounds.F32_OPS_PER_S)
