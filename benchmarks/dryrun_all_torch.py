"""Drive the port's (arch x shape x mesh) dry-run sweep as subprocesses: the
counterpart of ``benchmarks/dryrun_all.py``.

Each combination runs ``python -m repro_torch.launch.dryrun`` in a fresh
process (one count on meta tensors; ``src/repro_torch/launch/dryrun.py``).
Results are cached as JSON under ``experiments/dryrun_torch/``; reruns skip
existing files. Failures go to ``failures.log`` there.

Usage: PYTHONPATH=src python benchmarks/dryrun_all_torch.py [--meshes card1 pod1] [--archs xlstm-350m]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ARCHS = [
    # roughly smallest-count-first so failures surface early (the JAX sweep's order)
    "qwen3-0.6b",
    "whisper-tiny",
    "xlstm-350m",
    "granite-moe-3b-a800m",
    "granite-3-8b",
    "moonshot-v1-16b-a3b",
    "zamba2-7b",
    "gemma3-27b",
    "kimi-k2-1t-a32b",
    "qwen2-vl-72b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = ["card1", "pod1", "pod2"]
OUT = "experiments/dryrun_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def result_path(arch_name: str, shape: str, mesh: str) -> str:
    return os.path.join(ROOT, OUT, f"{arch_name}_{shape}_{mesh}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", nargs="+", default=MESHES, choices=MESHES)
    ap.add_argument("--archs", nargs="+", default=ARCHS)
    ap.add_argument("--shapes", nargs="+", default=SHAPES, choices=SHAPES)
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    os.makedirs(os.path.join(ROOT, OUT), exist_ok=True)
    fail_log = os.path.join(ROOT, OUT, "failures.log")
    failed = 0
    for mesh in args.meshes:
        for arch in args.archs:
            for shape in args.shapes:
                path = result_path(arch, shape, mesh)
                if os.path.exists(path):
                    print(f"cached  {arch} {shape} {mesh}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                       "--mesh", mesh, "--out", OUT]
                t0 = time.time()
                print(f"RUN     {arch} {shape} {mesh} ...", flush=True)
                try:
                    r = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout, cwd=ROOT,
                                       env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
                except subprocess.TimeoutExpired:
                    failed += 1
                    with open(fail_log, "a") as f:
                        f.write(f"=== {arch} {shape} {mesh} TIMEOUT\n")
                    print(f"TIMEOUT {arch} {shape} {mesh}")
                    continue
                if r.returncode != 0:
                    failed += 1
                    with open(fail_log, "a") as f:
                        f.write(f"=== {arch} {shape} {mesh} rc={r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}\n")
                    print(f"FAIL    {arch} {shape} {mesh} ({time.time() - t0:.0f}s) rc={r.returncode}")
                else:
                    print(f"ok      {arch} {shape} {mesh} ({time.time() - t0:.0f}s)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
