"""Edge-partitioned training and evaluation over ``torch.distributed``
(``relationprediction_tpu/parallel/``): ``mesh`` holds the mesh and the
batch and tree placement, ``collectives`` the all-reduces and the gather
of the models and the sharded step (``training.engine``), ``distributed``
the runtime that starts one process a rank. The names below load their
module at first use, so importing the package loads nothing."""
import importlib

_EXPORTS = {
    "EdgeMesh": "mesh", "make_mesh": "mesh", "shard_batch": "mesh",
    "replicate": "mesh", "all_reduce_sum": "collectives",
    "pmean": "collectives", "init_runtime": "distributed",
    "launch": "distributed", "is_coordinator": "distributed",
    "make_global_mesh": "distributed",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
