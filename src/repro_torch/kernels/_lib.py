"""Build and load the port's CUDA kernels: one shared library, plain C calls.

Every ``.cu`` file under ``kernels/`` exposes ``extern "C"`` launchers that
take raw device pointers and a CUDA stream and return ``cudaGetLastError()``.
Each source is compiled for ``sm_90a`` by its own ``nvcc -c``, all of them
started together, and one more ``nvcc -shared`` links the objects into one
library in ``build/repro_torch_kernels/`` at the root of the checkout, on
first use; the library is loaded with ``ctypes``. Nothing here includes
PyTorch's headers, so the build takes seconds, not minutes.

The library file name carries a hash of the sources and flags: an edited
source builds a new library, and a stale one is never loaded. Concurrent
builders (test workers) each build to a private temporary name and rename it
into place, which is atomic.

Every launch goes through ``call``: it runs the launcher on its device's
current stream, raises on a refused launch and counts it in ``launches``.

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

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
SOURCES = (
    _KERNELS_DIR / "gsproject" / "gsproject.cu",
    _KERNELS_DIR / "tile_raster" / "tile_raster.cu",
    _KERNELS_DIR / "tile_raster" / "slab_gather.cu",
    _KERNELS_DIR / "flash_attention" / "flash_attention.cu",
    _KERNELS_DIR / "adam" / "adam.cu",
)
# src/repro_torch/kernels -> the checkout root
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"

# No --use_fast_math: exp, sqrt, rsqrt and division stay accurate. No FMA
# contraction either, so each kernel rounds like its plain version, one
# PyTorch op per operation.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# launcher name -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    # means (N,3), log_scales (N,3), quats (N,4), opacity_logit (N,), sh
    # (N,C,3), sh_stride, cam (host, 32 floats), out (N,11), n, blur, stream
    "gsproject_fwd": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _F, _P),
    # the forward's arguments to cam, then gpacked (N,11), and the gradients
    # it writes: means (N,3), log_scales (N,3), quats (N,4), opacity_logit
    # (N,), sh (N,C,3); n, blur, stream
    "gsproject_bwd": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    # splats_t (T,11,K), valid (T,K), out (T,3,P), t_final (T,P), n_contrib
    # (T,P) int32, n_tiles, k, tiles_x, tile_h, tile_w, row_offset, stream
    "tile_raster_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # splats_t (T,11,K), valid (T,K), gout (T,3,P), gtfin (T,P), t_final
    # (T,P), n_contrib (T,P), dsplats (T,11,K), n_tiles, k, tiles_x, tile_h,
    # tile_w, row_offset, stream
    "tile_raster_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # tile_h, tile_w, out (4 ints: forward and backward CTAs per SM, then threads per CTA)
    "tile_raster_occupancy": (_I, _I, _P),
    # packed (N,11), order (N,) int64 or null, tile_idx (T,K) int32, slab
    # (T,11,K), n_tiles, k, stream
    "slab_gather_fwd": (_P, _P, _P, _P, _I, _I, _P),
    # n_slots (T*K), n_rows (N), out (one long long: the backward's scratch bytes)
    "slab_bwd_scratch_bytes": (_I, _I, _P),
    # dslab (T,11,K), valid (T,K) bool, tile_idx (T,K) int32, order (N,)
    # int64 or null, dpacked (N,11) zero-filled, scratch, scratch bytes,
    # n_tiles, k, n_rows, stream
    "slab_bwd": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P),
    # q (B,S,H,hd), k, v (B,Skv,Hkv,hd), out (B,S,H,hd), batch, s, skv,
    # heads, kv_heads, head_dim, is_bf16, causal, window (< 0: none),
    # q_offset, scale, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # p, g, m, v, p_out, m_out, v_out (n floats each), n, bc1, bc2, lr (0-d
    # device tensors; lr null: the float lr), lr, b1, 1 - b1, b2, 1 - b2,
    # eps, stream
    "adam_update": (_P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _F, _F, _F, _F, _F, _F, _P),
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # 0.0 when an up-to-date library was already on disk
    log: str         # nvcc's output (ptxas register / shared-memory report), kept beside the library


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
    log_path = path.with_suffix(".log")
    if path.exists():
        return Build(path, 0.0, log_path.read_text() if log_path.exists() else "")
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, out in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({p.returncode}):\n{out}")
        link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        Path(f"{tmp}.log").write_text("".join(logs))
        os.replace(f"{tmp}.log", log_path)
        os.replace(tmp, path)
    finally:
        for f in (tmp, f"{tmp}.log", *objs):
            if os.path.exists(f):
                os.unlink(f)
    return Build(path, time.perf_counter() - t0, "".join(logs))


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


def check_tensor(name: str, x: torch.Tensor, shape: tuple, dev: torch.device, dtype=torch.float32) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev``: what a launcher's raw pointer arguments assume."""
    if x.dtype != dtype or not x.is_contiguous() or x.device != dev or tuple(x.shape) != shape:
        raise ValueError(f"{name}: want contiguous {dtype} {shape} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


class LaunchCount:
    """A launcher's launch counter: ``n`` rises by one per launch."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0


_launches: dict[str, LaunchCount] = {}


def launches(name: str) -> LaunchCount:
    """The launch count of launcher ``name``: one object per name."""
    return _launches.setdefault(name, LaunchCount())


def call(name: str, dev: torch.device, *args) -> None:
    """Run launcher ``name`` on ``dev``'s current stream (passed after
    ``args``); raise if the launch was refused, else count it."""
    with torch.cuda.device(dev):
        err = getattr(library(), name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    check(name, err)
    launches(name).n += 1
