"""Runtime analysis for the port: the opt-in lockset race sanitizer
(``tsan.py``, a copy of the JAX package's, switched on by ``REPRO_TSAN=1``).
The static passes stay in the JAX package's ``analysis/`` and scan the port
too (``python -m repro.launch.analyze``)."""
