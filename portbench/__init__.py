"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
configuration (``configs/``), traffic mix (``traffic/``) and metric
(``metrics/``) is a file of its own, found by the name that
``BENCHMARK.json`` gives it.
"""
