"""splatbench: the benchmark of the PyTorch port (``mojosplat_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``harness/`` holds
the cells, the traffic generator, the program's adapter and the trace
reader; ``reference/`` the plain reference; ``metrics/`` one reader a
per-layer metric; ``configs/``, ``traffic/`` and ``checks/`` the data of
each configuration, mix and cell; ``tools/`` the budget finder and the
readings the correctness limits are set from; ``tests/`` its CPU tests
(``python -m pytest splatbench/tests``) and its card tests (``-m cuda``).
"""
