"""The device's busy time a step in the traced slices of the training
window: the union of kernel, copy and set intervals over the slices,
over the steps the slices recorded, in ms. The device's share of a step,
steadier than the step's host-clock pace, which moves with the host's
load."""
LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_triples_per_s"
UNIT = "ms"


def read(r):
    if r.kind != "train" or r.trace is None or not r.trace.tags:
        return None
    return 1e3 * r.trace.busy_s / len(r.trace.tags)
