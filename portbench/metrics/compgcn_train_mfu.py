"""Model FLOPs of a CompGCN training step
(``portbench.work_compgcn.train_step_flops`` from each step's
``composed_edges`` and ``queries`` counters: the per-edge form, the
composition at its definition's cost, backward at twice the forward)
over the mean host-clock period of the steps the profiler left alone,
times the card's float32 peak, in %."""
from portbench import bounds, work_compgcn
from portbench.trace import quiet_period, quiet_steps

LAYER = "train step"
SOURCE = "host_clock"
MOVES = "train_triples_per_s"
UNIT = "%"


def read(r):
    if r.kind != "train" or r.shape.get("model") != "compgcn":
        return None
    steps = [s for s in quiet_steps(r) if "composed_edges" in s]
    period = quiet_period(r)
    if not steps or period is None:
        return None
    flops = sum(work_compgcn.train_step_flops(
        r.shape, s["composed_edges"], s["queries"]) for s in steps) \
        / len(steps)
    return 100.0 * flops / (period * bounds.F32_OPS_PER_S)
