"""The benchmark of the PyTorch/CUDA port (``relationprediction_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and
prints one JSON result line. Everything that belongs to one configuration,
traffic mix, cell or per-layer metric is a file of its own under
``configs/``, ``traffic/``, ``workloads/`` and ``metrics/``, found by name.
The yardstick (bound arithmetic, model FLOPs, the plain reference and the
comparison that decides ``correct``) is frozen here, apart from the port.
"""
