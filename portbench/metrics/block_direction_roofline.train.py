"""``block_direction_kernel`` (forward and twin launches) against its
roofline in the traced training slices: the least time a step's block
aggregations need (``portbench.bounds.block_direction_bound`` on each
recorded step's four layouts, once a layer) over the kernels' device time
a step (their time over the launches, times the launches a step), in %.
The carry fix-up (``carry_fixup_kernel``) is not counted: its name is
shared with the other merge-path kernels."""
from portbench import bounds

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_triples_per_s"
UNIT = "%"
KERNELS = r"\bblock_direction_kernel\b"


def step_least_s(graph, r) -> float:
    s = r.shape
    return s["n_layers"] * sum(
        bounds.block_direction_bound(lay, r.n_vertices, s["n_blocks"],
                                     s["dr"])["bound_s"]
        for lay in (graph.fwd, graph.bwd, graph.fwd_twin, graph.bwd_twin))


def read(r):
    if r.kind != "train" or r.trace is None or r.shape["variant"] != "block":
        return None
    graphs = r.trace.tags
    seconds, launches = r.trace.family_seconds(KERNELS)
    per_step = 4 * r.shape["n_layers"]
    least = sum(step_least_s(g, r) for g in graphs) / len(graphs)
    return 100.0 * least / (seconds * per_step / launches)
