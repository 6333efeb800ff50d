"""The device's idle share in the traced slices of the training window:
1 - (union of kernel, copy and set intervals) / (the slices' device
spans), in %."""
LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_triples_per_s"
UNIT = "%"


def read(r):
    if r.kind != "train" or r.trace is None or not r.trace.slices:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
