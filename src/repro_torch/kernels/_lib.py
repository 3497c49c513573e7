"""Build and load the port's CUDA kernels: one shared library, plain C calls.

Every ``.cu`` file under ``kernels/`` exposes ``extern "C"`` launchers that
take raw device pointers and a CUDA stream and return ``cudaGetLastError()``.
All of them are compiled by ONE ``nvcc -shared`` call for ``sm_90a`` into
``build/repro_torch_kernels/`` at the root of the checkout, on first use, and
the library is loaded with ``ctypes``. Nothing here includes PyTorch's
headers, so the build takes seconds, not minutes.

The library file name carries a hash of the sources and flags: an edited
source builds a new library, and a stale one is never loaded. Concurrent
builders (test workers) each build to a private temporary name and rename it
into place, which is atomic.

Nothing is built or loaded at import: the CPU-only test host imports every
module and has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_KERNELS_DIR = Path(__file__).resolve().parent
SOURCES = (
    _KERNELS_DIR / "gsproject" / "gsproject.cu",
    _KERNELS_DIR / "tile_raster" / "tile_raster.cu",
)
# src/repro_torch/kernels -> the checkout root
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"

# No --use_fast_math: exp, sqrt, rsqrt and division stay accurate. No FMA
# contraction either, so each kernel rounds like its plain version, one
# PyTorch op per operation.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# launcher name -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    # means (N,3), log_scales (N,3), quats (N,4), opacity_logit (N,), sh
    # (N,C,3), sh_stride, cam (host, 32 floats), out (N,11), n, blur, stream
    "gsproject_fwd": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _F, _P),
    # splats_t (T,11,K), valid (T,K), out (T,3,P), t_final (T,P),
    # n_tiles, k, tiles_x, tile_h, tile_w, row_offset, stream
    "tile_raster_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # 0.0 when an up-to-date library was already on disk
    log: str         # nvcc's output (ptxas register / shared-memory report)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME or PATH)")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Build:
    """Compile every kernel source into one shared library (if not yet built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if path.exists():
        return Build(path, 0.0, "")
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(path, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build_library().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


class LaunchCount:
    """A kernel wrapper's launch counter: ``n`` rises by one per launch."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0
