"""The benchmark of ``yolo_tpu_torch`` on one NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything that
belongs to one configuration, traffic mix or metric is a file of its own,
found by its name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py``, ``references/<config>.py``
and ``counts/<config>.py``. Nothing here imports JAX or the JAX package.
"""
