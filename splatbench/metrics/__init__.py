"""Per-layer metrics: one reader a metric, ``<name>.py`` with
``read(ctx) -> float | None``, found by the metric's name in
``BENCHMARK.json``. ``ctx`` holds the traced window: ``kind`` ("train" or
"orbit"), ``family``, ``units``, ``window_s``, ``busy_s``, ``kernels``
(device kernels launched), ``kernel_seconds(fragment)`` and ``work`` (the
reference's counts for the window's poses, ``_work.py``). A reader that
finds nothing to read in a cell returns None.
"""
