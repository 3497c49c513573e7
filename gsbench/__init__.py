"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything a cell needs
is found by name: its configuration in ``configs/``, its traffic in
``traffic/``, its cell file in ``workloads/`` and one reader per per-layer
metric in ``metrics/``. The inputs come from ``scene/``, the plain
reference that decides ``correct`` from ``reference/``, and the least-work
counts behind the roofline shares from ``work/``. None of it imports JAX,
the JAX package ``repro``, or (in ``scene/``, ``reference/`` and ``work/``)
anything of ``repro_torch``.
"""
