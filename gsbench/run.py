"""Run one cell of the benchmark of the PyTorch and CUDA port once.

  python3 gsbench/run.py --workload ks4m-train-512 --seed 1234567890123 --seconds 30 --trace 0

The cell (``gsbench/workloads/<name>.json``), its configuration and its
traffic are found by name. Its set-up makes the inputs from ``--seed`` on
the card, builds ``repro_torch``'s ``GSTrainer`` and runs its first steps;
the window runs ``GSTrainer.fit`` for ``--seconds``; the reference then
decides ``correct``. A cell on several chips runs one process per chip,
started by the port's ``launch/mesh.py``, and rank 0's line is printed here.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``compared`` last: each number compared and its limit), and
the last lines of standard error repeat the numbers compared. It exits
non-zero and prints no result when there is no CUDA device or fewer than
the cell asks for, or when JAX or the JAX package ``repro`` was loaded.
"""
import time

T0 = time.time()  # process start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

RANKS_TIMEOUT_S = 330.0


def _rank(rank: int, world: int, opts: dict) -> None:
    from gsbench.harness import run_rank

    run_rank(rank, world, opts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json (gsbench/workloads/<name>.json)")
    ap.add_argument("--seed", type=int, required=True, help="makes the inputs, the weights and the batch order")
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: per-layer metrics from the trainer's spans and a profiled stretch of steps")
    args = ap.parse_args(argv)

    from gsbench.harness import forbidden_modules, load_cell, run_rank

    cell = load_cell(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available():
        print("gsbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"gsbench: {args.workload} needs {chips} CUDA devices, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    opts = dict(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device="cuda", t0=T0)
    if chips == 1:
        result = run_rank(0, 1, opts)
    else:
        from repro_torch.launch.mesh import spawn_ranks

        with tempfile.TemporaryDirectory(prefix="gsbench-") as tmp:
            opts.update(rendezvous=os.path.join(tmp, "rendezvous"), result_path=os.path.join(tmp, "result.json"))
            spawn_ranks(_rank, (chips, opts), chips, timeout_s=RANKS_TIMEOUT_S)
            with open(opts["result_path"]) as f:
                result = json.load(f)
    found = sorted(set(result.pop("forbidden_modules")) | set(forbidden_modules()))
    if found:
        print(f"gsbench: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, v in result["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
