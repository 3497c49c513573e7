"""Dry run of one (architecture x shape) on H100 terms: count the port's own
train, prefill or serve step on ``meta`` stand-ins and turn the count into
a three-term roofline (compute, memory, collectives).

The JAX package compiles the step for a TPU pod and reads XLA's cost
analysis. The port compiles nothing, so it runs its step on ``meta``
tensors (shapes only, nothing allocated) under ``launch/op_cost.py``
``OpCost``, which counts every dispatched op and the attention kernel's
own work. Meshes:

* ``card1``: the whole shape on one H100, nothing divided.
* ``pod1`` / ``pod2``: ``launch/mesh.py`` ``make_production_mesh`` (256 or
  512 cards). The argument bytes per card are exact, from the partition
  specs (``models/partitioning.py`` ``per_device_bytes``). Flops, bytes and
  peak live bytes are the global count divided by the card count (the JSON
  says so under ``per_card``). Collective bytes are the weights' traffic
  from the specs by the ring formulas: an FSDP all-gather of each
  data-sharded weight per forward (and per recompute under remat), a
  reduce-scatter of its gradient, an all-reduce of each gradient that is
  replicated over a batch axis. No SPMD compiler gives the activation
  traffic of tensor parallelism, so ``collectives_counted`` is "weights
  only". Model-axis bytes go over NVLink, data- and pod-axis bytes over the
  network (``launch/mesh.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b --shape long_500k --mesh pod2
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

from repro_torch.configs import get_arch
from repro_torch.configs.common import SHAPES, ShapeCase, decode_specs, lm_batch_specs, params_specs
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16, LogicalMesh, axis_bandwidth, \
    make_production_mesh
from repro_torch.launch.op_cost import ring_moved_bytes, OpCost
from repro_torch.models import api
from repro_torch.models.params import tree_leaves
from repro_torch.models.partitioning import batch_pspecs, cache_pspecs, param_pspecs, per_device_bytes, spec_leaves
from repro_torch.models.sharding import PURE_DP_RULES, mesh_rules

MESHES = ("card1", "pod1", "pod2")


def _mesh(tag: str) -> LogicalMesh:
    if tag == "card1":
        return LogicalMesh({})
    return make_production_mesh(multi_pod=tag == "pod2")


def _axes(spec_entry) -> tuple:
    if spec_entry is None:
        return ()
    return spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)


def weight_collectives(params, specs, mesh_shape: dict, batch_axes: tuple, *, forwards: int, train: bool) -> dict:
    """Per-card moved bytes and seconds of the weights' collectives (see the
    module docstring), by kind and by axis group."""
    rows: dict = {}

    def add(kind, axes, nbytes_result):
        n = math.prod(mesh_shape[a] for a in axes)
        if n <= 1:
            return
        moved = ring_moved_bytes(kind, nbytes_result, n)
        bw = min(axis_bandwidth(a) for a in axes)
        key = f"{kind} over {'x'.join(axes)}"
        row = rows.setdefault(key, {"count": 0, "moved_bytes": 0.0, "seconds": 0.0})
        row["count"] += 1
        row["moved_bytes"] += moved
        row["seconds"] += moved / bw

    for leaf, spec in zip(tree_leaves(params), spec_leaves(specs), strict=True):
        sharded = {a for e in spec for a in _axes(e)}
        full = leaf.numel() * leaf.element_size()
        shard = full // math.prod(mesh_shape[a] for a in sharded) if sharded else full
        fsdp_axes = tuple(a for a in batch_axes if a in sharded)
        rest_axes = tuple(a for a in batch_axes if a not in sharded)
        if fsdp_axes:
            gathered = shard * math.prod(mesh_shape[a] for a in fsdp_axes)
            for _ in range(forwards):
                add("all-gather", fsdp_axes, gathered)
            if train:
                add("reduce-scatter", fsdp_axes, shard)
        if train and rest_axes:
            add("all-reduce", rest_axes, shard)
    return rows


def run_dryrun(arch: str, shape_name: str, *, mesh: str = "card1", fsdp: bool = True, out_dir: str | None = None,
               seq_len: int | None = None, global_batch: int | None = None) -> dict:
    """Count one step and write its JSON (``out_dir``). ``seq_len`` and
    ``global_batch`` count the shape cut to that sequence or batch (the
    JSON records both)."""
    if mesh not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, got {mesh!r}")
    mod = get_arch(arch)
    cfg = mod.config()
    shape = SHAPES[shape_name]
    if seq_len is not None or global_batch is not None:
        shape = ShapeCase(seq_len or shape.seq_len, global_batch or shape.global_batch, shape.kind)
    lm = _mesh(mesh)
    n_cards = max(lm.size, 1)
    result = {"arch": cfg.name, "shape": shape_name, "mesh": mesh, "kind": shape.kind, "devices": n_cards,
              "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    skip = getattr(mod, "SKIP_SHAPES", {}).get(shape_name)
    if skip:
        result["skipped"] = skip
        _write(result, out_dir)
        print(f"SKIP {arch} {shape_name}: {skip}")
        return result

    rules = mesh_rules(PURE_DP_RULES if getattr(cfg, "pure_dp", False) else None)
    batch_axes = tuple(a for a in rules["batch"] if a in lm.shape)
    if shape.kind == "decode":
        fsdp = False  # decode keeps weights model-sharded only, as the JAX dry run does
    # the step's arguments are built before the count, so its peak live
    # bytes are the step's temporaries only (JAX's ``temp_size_in_bytes``)
    params = params_specs(cfg)
    pspecs = param_pspecs(cfg, params, lm, fsdp=fsdp)
    arg_trees = [(params, pspecs)]
    if shape.kind == "train":
        opt = api.adamw_init(params)
        batch = lm_batch_specs(cfg, shape)
        arg_trees += [(opt["m"], pspecs), (opt["v"], pspecs), (batch, batch_pspecs(cfg, batch, lm))]
    elif shape.kind == "prefill":
        batch = lm_batch_specs(cfg, shape)
        arg_trees.append((batch, batch_pspecs(cfg, batch, lm)))
    else:
        specs = decode_specs(cfg, shape)
        arg_trees += [(specs["cache"], cache_pspecs(cfg, specs["cache"], lm)),
                      ({"t": specs["tokens"]}, batch_pspecs(cfg, {"t": specs["tokens"]}, lm))]
    t0 = time.perf_counter()
    with OpCost() as counter:
        if shape.kind == "train":
            _, _, out = api.make_train_step(cfg)(params, opt, batch)
            outputs = [out["loss"]]
        elif shape.kind == "prefill":
            outputs = [api.make_prefill_step(cfg)(params, batch)]
        else:
            logits, _ = api.make_serve_step(cfg)(params, specs["cache"], specs["tokens"], specs["pos"])
            outputs = [logits]
    count_s = time.perf_counter() - t0
    cost = counter.result()

    # ---- per card
    arg_bytes = sum(per_device_bytes(t, s, lm) for t, s in arg_trees)
    flops = cost["flops"] / n_cards
    bytes_hbm = cost["bytes"] / n_cards
    temp = cost["peak_live_bytes"] / n_cards
    out_bytes = sum(x.numel() * x.element_size() for x in outputs) / n_cards
    alias = 0  # the step's in-place updates: parameters and moments, or the cache
    if shape.kind == "train":
        alias = sum(per_device_bytes(t, s, lm) for t, s in arg_trees[:3])
    elif shape.kind == "decode":
        alias = per_device_bytes(arg_trees[1][0], arg_trees[1][1], lm)
    forwards = 1 + int(bool(getattr(cfg, "remat", False))) if shape.kind == "train" else 1
    coll = weight_collectives(params, pspecs, lm.shape, batch_axes, forwards=forwards,
                              train=shape.kind == "train") if n_cards > 1 else {}
    bytes_coll = sum(r["moved_bytes"] for r in coll.values())

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_hbm / HBM_BW
    collective_s = sum(r["seconds"] for r in coll.values())
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    model_flops_chip = model_flops / n_cards
    dominant = max(("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
                   key=lambda kv: kv[1])[0]
    peak = arg_bytes + temp
    result.update({
        "count_s": round(count_s, 1),
        "counter": "launch/op_cost.py OpCost on meta tensors",
        "per_card": "global count / cards" if n_cards > 1 else "the whole shape on one card",
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_estimate_bytes": peak,
            "fits_80gb": peak < HBM_BYTES,
        },
        "flops": flops,
        "bytes": bytes_hbm,
        "collective_moved_bytes": bytes_coll,
        "collectives": coll,
        "collectives_counted": "weights only" if n_cards > 1 else "none (one card)",
        "top_bytes": cost["top_bytes"],
        "by_op": cost["by_op"],
        "roofline": {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s,
                     "dominant": dominant},
        "model_flops_per_chip": model_flops_chip,
        "useful_flop_ratio": model_flops_chip / flops if flops else None,
        "params_total": cfg.param_count(),
        "params_active": n_active,
    })
    _write(result, out_dir)
    print(f"{arch} {shape_name} {mesh}: counted in {count_s:.1f}s  compute {compute_s * 1e3:.2f}ms  "
          f"memory {memory_s * 1e3:.2f}ms  collective {collective_s * 1e3:.2f}ms  dominant={dominant}  "
          f"useful={result['useful_flop_ratio'] and round(result['useful_flop_ratio'], 3)}  "
          f"peak {peak / 1e9:.2f} GB")
    return result


def _write(result: dict, out_dir: str | None) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{result['arch']}_{result['shape']}_{result['mesh']}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Count one step of the port on meta tensors; H100 roofline terms")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="card1", choices=MESHES)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--seq-len", type=int, default=None, help="count at this sequence length instead")
    ap.add_argument("--batch", type=int, default=None, help="count at this global batch instead")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    run_dryrun(args.arch, args.shape, mesh=args.mesh, fsdp=not args.no_fsdp, out_dir=args.out, seq_len=args.seq_len,
               global_batch=args.batch)


if __name__ == "__main__":
    main()
