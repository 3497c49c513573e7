"""The port's invariant lints and lockset race sanitizer, the JAX package's
``analysis/`` in the port's own copy.

Static passes (AST only: importing this package imports neither JAX nor
torch):

* ``retrace.py``: the one-build-per-sequence invariant (jit/shard_map
  and, in PyTorch's spelling, ``torch.compile`` and CUDA-graph construction
  in loops and per-call functions; unhashable static args).
* ``names.py``: metric/span name vocabulary coherence across code,
  benchmarks, tests and docs.
* ``locks.py``: per-class lock discipline across the gateway,
  render-executor and checkpoint-writer thread boundaries.
* ``hygiene.py``: broad exception-handler lint.

Runtime sanitizer (opt-in, ``REPRO_TSAN=1``): ``tsan.py``.
CLI: ``python -m repro_torch.launch.analyze`` (report + baseline ratchet),
the same flags, defaults, baseline and pragmas as the JAX package's CLI.
"""
from repro_torch.analysis.common import (
    Finding,
    SourceFile,
    baseline_key,
    diff_against_baseline,
    iter_python_files,
    load_baseline,
    load_tree,
    save_baseline,
)

__all__ = [
    "Finding",
    "SourceFile",
    "baseline_key",
    "diff_against_baseline",
    "iter_python_files",
    "load_baseline",
    "load_tree",
    "save_baseline",
]
