"""``basis_project`` (the split pass ``tf32_split_kernel`` and the product
``project_kernel``) against its roofline in the traced training slices:
a step's eight products X [V, d] @ W [d, B d] (each layer's two
directions, forward and twin) at their own work
(``portbench.bounds.project_bound``: 2 M K N at the f32-exact tensor-core
rate) over the two kernels' device time a step, in %."""
from portbench import bounds

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_triples_per_s"
UNIT = "%"
KERNELS = r"\b(tf32_split_kernel|project_kernel)\b"


def read(r):
    if r.kind != "train" or r.trace is None or r.shape["variant"] != "basis":
        return None
    s = r.shape
    products = 4 * s["n_layers"]
    least = products * bounds.project_bound(
        r.n_vertices, s["d"], s["n_bases"] * s["d"])["bound_s"]
    seconds, launches = r.trace.family_seconds(KERNELS)
    return 100.0 * least / (seconds * 2 * products / launches)
