"""Roofline table of the port's dry run: read the JSONs of
``benchmarks/dryrun_all_torch.py`` and print the three-term roofline per
(arch x shape) on one mesh, with the dominant term, the useful-flop ratio,
whether the step fits one H100's 80 GB and the one-line note (the
counterpart of ``benchmarks/roofline.py``), then the peak estimate per card
in GB. ``grid`` prints the arch x shape grid instead: ``card1``'s compute /
memory ms, dominant term (C, M, N), useful-flop ratio and peak GB (*: over
80 GB), and ``pod1``'s where one card does not hold the step. ``gs``
prints the GS steps of ``benchmarks/gs_dryrun_torch.py``'s JSONs (in the
directories given) by scene and frame over 1, 2 and 4 cards; the gather
transposes are its ``index_put`` bytes.

  PYTHONPATH=src python benchmarks/roofline_torch.py [card1|pod1|pod2|grid]
  PYTHONPATH=src python benchmarks/roofline_torch.py gs DIR [DIR ...]
"""
from __future__ import annotations

import glob
import json
import os
import sys

NOTES = {
    "compute": "raise arithmetic intensity (bf16 matmul paths, larger per-chip tiles)",
    "memory": "fuse/shorten elementwise chains, bf16 intermediates, fewer remat recomputes",
    "collective": "re-shard to cut gathered bytes (seq-shard caches, 2D weight sharding), overlap with compute",
}


def load(dirname="experiments/dryrun_torch", mesh="card1"):
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, f"*_{mesh}.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def table(out=print, dirname="experiments/dryrun_torch", mesh="card1"):
    rows = load(dirname, mesh)
    out("arch,shape,compute_ms,memory_ms,collective_ms,dominant,useful_flop_ratio,fits_80gb,note,peak_gb")
    for d in rows:
        if d.get("skipped"):
            out(f"{d['arch']},{d['shape']},SKIP({d['skipped'][:40]}),,,,,,,")
            continue
        r = d["roofline"]
        ratio = d.get("useful_flop_ratio")
        out(
            f"{d['arch']},{d['shape']},{r['compute_s'] * 1e3:.2f},{r['memory_s'] * 1e3:.2f},"
            f"{r['collective_s'] * 1e3:.2f},{r['dominant']},"
            + (f"{ratio:.3f}" if ratio else "n/a")
            + f",{d['memory_analysis']['fits_80gb']},{NOTES[r['dominant']]}"
            + f",{d['memory_analysis']['peak_estimate_bytes'] / 1e9:.1f}"
        )
    return rows


def _cell(d: dict, with_collective: bool) -> str:
    r, m = d["roofline"], d["memory_analysis"]
    terms = [r["compute_s"], r["memory_s"]] + ([r["collective_s"]] if with_collective else [])
    ratio = d.get("useful_flop_ratio")
    return ("/".join(f"{t * 1e3:.1f}" for t in terms) + f" {'CMN'[('compute', 'memory', 'collective').index(r['dominant'])]}"
            + (f" {ratio:.2f}" if ratio and not with_collective else "")
            + f" {m['peak_estimate_bytes'] / 1e9:.1f}" + ("" if m["fits_80gb"] else "*"))


def grid(out=print, dirname="experiments/dryrun_torch"):
    """The arch x shape grid: ``card1``, then ``pod1`` where one card does
    not hold the step."""
    card = {(d["arch"], d["shape"]): d for d in load(dirname, "card1")}
    pod = {(d["arch"], d["shape"]): d for d in load(dirname, "pod1")}
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    out("| arch | " + " | ".join(shapes) + " |")
    out("|---" * (len(shapes) + 1) + "|")
    for arch in sorted({a for a, _ in card}):
        cells = []
        for shape in shapes:
            d = card.get((arch, shape))
            if d is None:
                cells.append("not counted")
            elif d.get("skipped"):
                cells.append("skip")
            else:
                cell = _cell(d, False)
                p = pod.get((arch, shape))
                if not d["memory_analysis"]["fits_80gb"] and p is not None and not p.get("skipped"):
                    cell += "; pod1 " + _cell(p, True)
                cells.append(cell)
        out(f"| {arch} | " + " | ".join(cells) + " |")


def gs_table(dirs, out=print, worlds=(1, 2, 4)):
    """The GS steps by (scene, points, px): memory ms, measured p50 ms and
    roofline share on 1, 2 and 4 cards, the 1-card count and peak, the
    4-card collective bytes and the 1-card ``index_put`` bytes."""
    runs = {}
    for d in dirs:
        for path in glob.glob(os.path.join(d, "*.json")):
            with open(path) as f:
                r = json.load(f)
            if r.get("data_par", 1) == 1:
                runs[(r["name"], r["points"], r["res"], r["workers"])] = r

    def per(key, fmt, fn):
        vals = [runs.get(key + (w,)) for w in worlds]
        vals = [None if v is None else fn(v) for v in vals]  # None: not run, or not measured (CPU)
        return " / ".join("n/a" if v is None else fmt.format(v) for v in vals)

    out("| scene | px | flops / bytes (1 card) | memory ms, 1 / 2 / 4 cards | measured ms, 1 / 2 / 4 | "
        "share, 1 / 2 / 4 | collective B (4) | transposes B (1), share of bytes | peak B (1) |")
    out("|---|---|---|---|---|---|---|---|---|")
    for key in sorted({k[:3] for k in runs}, key=lambda k: (k[1], k[0], k[2])):
        one, four = runs.get(key + (1,)), runs.get(key + (4,))
        if one is None:
            continue
        pw = one["per_worker"]
        idx = sum(v["bytes"] for k, v in one["by_op"].items() if k.startswith("index_put"))
        coll = f"{four['per_worker']['collective_bytes']:.4e}" if four else "n/a"
        out(f"| {key[0]} {key[1]} | {key[2]} | {pw['flops']:.4e} / {pw['hbm_bytes']:.4e} | "
            + per(key, "{:.3f}", lambda r: r["roofline_s"]["memory"] * 1e3) + " | "
            + per(key, "{:.3f}", lambda r: r["measured_step_ms"]) + " | "
            + per(key, "{:.4f}", lambda r: r["roofline_share"])
            + f" | {coll} | {idx:.4e}, {idx / pw['hbm_bytes']:.4f} | {pw['peak_bytes']} |")


if __name__ == "__main__":
    if sys.argv[1:2] == ["gs"]:
        gs_table(sys.argv[2:])
    elif sys.argv[1:2] == ["grid"]:
        grid()
    else:
        table(mesh=sys.argv[1] if len(sys.argv) > 1 else "card1")
