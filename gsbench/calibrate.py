"""Readings that a cell's limits are set from: the program against the
reference over many seeds, the control and the planted faults.

  python3 gsbench/calibrate.py --workload ks4m-train-512 --seeds 11 12 13 ... \\
      --control-seeds 11 12 13 --fault-seeds 11 12 13 --faults unchanged half_batch altered \\
      --out chiprun_out/calibrate.jsonl

For each seed, in one process a chip: the program's first three steps, as
``run.py``'s set-up drives them (no window), once sound and once with each
fault of ``--faults`` planted (``gsbench/faults.py``) on the fault seeds;
then, on rank 0, the reference over the same inputs, and on the control
seeds the reference again with TF32 products (the control). One JSON line
per seed and kind: the numbers ``run.py`` compares. The benchmark's own
runs never run this.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402


def _rank(rank: int, world: int, opts: dict) -> None:
    from gsbench.faults import plant
    from gsbench.harness import (build_trainer, card_line, gaps, log, program_readings, reference_readings,
                                 setup)
    from gsbench.scene import FIELDS, batch_order

    cell = opts["cell"]
    dev, mesh, cams, prog_cams, gt = setup(rank, world, opts)
    for seed in opts["seeds"]:
        progs = {}
        kinds = ["sound"] + (opts["faults"] if seed in opts["fault_seeds"] else [])
        for kind in kinds:
            undo = plant(kind) if kind != "sound" else None
            try:
                tr, _, _ = build_trainer(cell, seed, dev, mesh, False)
                progs[kind] = program_readings(tr, prog_cams, gt, batch_order(cell["config_data"]["views"],
                                                                                cell["traffic_data"]["batch"], seed), mesh)
            finally:
                if undo is not None:
                    undo()
            del tr
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if rank == 0:
            views = progs["sound"]["views"]
            ref = reference_readings(cell, seed, cams, gt, views, dev)
            lines = [dict(kind=k, **gaps(p, ref, FIELDS), losses=p["losses"]) for k, p in progs.items()]
            if seed in opts["control_seeds"]:
                ctl = reference_readings(cell, seed, cams, gt, views, dev, tf32=True)
                ctl = dict(ctl, grad_norms=[ctl["grad_norms"][f] for f in FIELDS],
                           change_norms=[ctl["change_norms"][f] for f in FIELDS])
                lines.append(dict(kind="control_tf32", **gaps(ctl, ref, FIELDS), losses=ctl["losses"]))
            with open(opts["out"], "a") as f:
                for line in lines:
                    rec = dict(workload=cell["name"], seed=seed, card=card_line(), ref_losses=ref["losses"],
                               ref_grad_norms=ref["grad_norms"], ref_change_norms=ref["change_norms"], **line)
                    f.write(json.dumps(rec) + "\n")
                    print(json.dumps({k: rec[k] for k in ("seed", "kind", "loss_gap", "grad_gap", "change_gap")}),
                          flush=True)
            log(opts, rank, f"seed {seed} done")
        if mesh is not None:
            mesh.barrier()
    if mesh is not None:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out", required=True, help="JSON lines, appended")
    args = ap.parse_args(argv)

    from gsbench.harness import load_cell
    from repro_torch.launch.mesh import spawn_ranks

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"calibrate: {args.workload} needs {cell['chips']} CUDA devices", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    opts = dict(cell=cell, seeds=args.seeds, control_seeds=set(args.control_seeds), fault_seeds=set(args.fault_seeds),
                faults=args.faults, out=os.path.abspath(args.out), device="cuda", t0=T0)
    if cell["chips"] == 1:
        _rank(0, 1, opts)
        return 0
    with tempfile.TemporaryDirectory(prefix="gsbench-calibrate-") as tmp:
        opts["rendezvous"] = os.path.join(tmp, "rendezvous")
        spawn_ranks(_rank, (cell["chips"], opts), cell["chips"], timeout_s=3300.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
