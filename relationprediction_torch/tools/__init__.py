"""Offline tools (ensemble, dictionaries, subgraph, make_datasets,
cluster), the port's copies of ``relationprediction_tpu/tools/``.

Submodules are imported lazily so ``python -m
relationprediction_torch.tools.<tool>`` runs without double-import
warnings.
"""
