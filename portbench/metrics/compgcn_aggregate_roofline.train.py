"""The merge-path kernel of ``staircase_aggregate`` (``merge_path_kernel``)
against its roofline in the traced CompGCN training slices: the least
time of a step's four sums (``portbench.bounds_compgcn``: the two halves'
weighted sums into their targets at the layer's width and the gathers'
gradients summed by id at the input width, on the whole graph's layouts)
over the kernel's device time a step (its time over its launches, times
the launches a step), in %. The carry fix-up is not counted: its name is
shared with the other merge-path kernels."""
from portbench import bounds_compgcn

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_triples_per_s"
UNIT = "%"
KERNELS = r"\bmerge_path_kernel\b"


def read(r):
    if r.kind != "train" or r.trace is None \
            or r.shape.get("model") != "compgcn":
        return None
    launches = r.shape["aggregate_launches"]
    seconds, count = r.trace.family_seconds(KERNELS)
    least = bounds_compgcn.step_least_s(launches)
    return 100.0 * least / (seconds * len(launches) / count)
