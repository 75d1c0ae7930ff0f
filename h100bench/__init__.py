"""The benchmark of ``instageo_tpu_torch`` on one NVIDIA H100.

``run.py`` is the entry; everything that belongs to one configuration, one
traffic mix or one per-layer metric lives in a file of its own
(``configs/``, ``traffic/``, ``metrics/``, ``limits/``), found by the name
that ``BENCHMARK.json`` gives it.
"""
