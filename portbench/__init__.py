"""The benchmark of varden_tpu_torch on one NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``. ``reference/`` holds
the plain PyTorch reference that decides ``correct``.
"""
