"""Network frontend load of the PyTorch port: N asyncio clients over
localhost TCP vs the in-process pipelined baseline (the mirror of
``benchmarks/frontend_load.py``, with its laps, report keys and exit
conditions), on one card or, with ``--device cpu``, through the plain
versions.

Methodology: one shared serving pool with TWO registered streams — a static
synthetic isosurface scene and a real ``TemporalCheckpointStore``-backed
insitu timeline (recorded into a temp dir at startup). The same request
trace (every client walks an orbit; odd clients scrub the timeline, even
clients orbit the static scene) is driven twice over warmed jit traces:

  in-process — submit straight into the RenderServer, pipelined drain
               (the ``serve_throughput.py`` serving discipline)
  network    — N concurrent asyncio clients connect to the gateway over
               localhost TCP, each awaiting its frames end-to-end (protocol
               encode/decode + RGB8/zlib-delta frame encoding included)

Between laps the frame cache and metrics reset, so both laps render cold.
Reports aggregate fps, client-observed p50/p99 latency, shed/drop/protocol
error counts, bytes on the wire, and the network/in-process fps ratio;
writes a BENCH_frontend.json perf-trajectory record. Exits nonzero if any
request was dropped without a shed notice, anything was shed at all (the
trace is sized within admission capacity), any protocol error occurred, or
the fps ratio falls below ``--min-ratio``.

  PYTHONPATH=src python benchmarks/frontend_load_torch.py --smoke --device cpu --out BENCH_frontend.json
  PYTHONPATH=src python benchmarks/frontend_load_torch.py --res 512 --out BENCH_frontend.json

``--config-from RECOMMEND.json`` takes the gateway and engine knobs from a
recommendation that ``python -m repro_torch.launch.tune`` wrote (or a bare
knob dict), as the JAX benchmark does.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from bench_schema import stage_breakdown, write_bench  # noqa: E402
from repro_torch.core.config import GSConfig  # noqa: E402
from repro_torch.frontend import (  # noqa: E402
    AsyncFrontendClient,
    Gateway,
    GatewayThread,
    SessionManager,
)
from repro_torch.insitu import TemporalCheckpointStore, timeline_stream  # noqa: E402
from repro_torch.launch.frontend import synthetic_timeline  # noqa: E402
from repro_torch.launch.serve_gs import init_params_from_volume  # noqa: E402
from repro_torch.launch.tune import load_recommended_knobs  # noqa: E402
from repro_torch.obs import Histogram, trace_meta, validate_trace_jsonl, write_trace  # noqa: E402
from repro_torch.serve_gs import make_clients  # noqa: E402
from repro_torch.serve_gs.server import _percentile  # noqa: E402


def record_timeline(params, n_steps: int, directory: str) -> TemporalCheckpointStore:
    """Record a small drifting sequence into a real temporal store (the
    'timeline' stream is then served exactly like a recorded insitu run)."""
    with TemporalCheckpointStore(directory, keyframe_interval=2) as store:
        for t, p in sorted(synthetic_timeline(params, n_steps).items()):
            store.append(t, p)
    return TemporalCheckpointStore(directory)


def build_trace(args):
    """Per-client (stream, timestep, camera) request sequences — identical
    for the in-process and network laps."""
    orbits = make_clients(
        args.clients, n_views=12, img_h=args.res, img_w=args.res, shared_orbit=False
    )
    trace = []
    for c, orbit in enumerate(orbits):
        reqs = []
        for r in range(args.requests):
            cam = orbit.next_camera()
            if c % 2 == 0:
                reqs.append(("static", 0, cam))
            else:
                reqs.append(("timeline", r % args.timeline_steps, cam))
        trace.append(reqs)
    return trace


def run_inprocess(manager: SessionManager, trace, *, laps=2) -> dict:
    """The pipelined in-process baseline: wavefront submits, ring drain.
    Best of ``laps`` cold-cache runs (scheduler-noise hygiene, matching
    ``serve_throughput.py``)."""
    server = manager.server
    best = None
    for _ in range(laps):
        server.cache.drop(lambda k: True)  # every lap renders cold
        t0 = time.perf_counter()
        lat = []
        for r in range(len(trace[0])):
            wave = []
            for c, reqs in enumerate(trace):
                stream, t, cam = reqs[r]
                ts = time.perf_counter()
                wave.append(
                    (server.submit(cam, timestep=manager.resolve(stream, t), client_id=c), ts)
                )
            server.run()
            for fut, ts in wave:
                fut.result()
                lat.append(time.perf_counter() - ts)
        wall = time.perf_counter() - t0
        n = sum(len(r) for r in trace)
        rep = {
            "submitted": n,
            "frames_per_s": round(n / wall, 2),
            "p50_ms": round(_percentile([x * 1e3 for x in lat], 50), 3),
            "p99_ms": round(_percentile([x * 1e3 for x in lat], 99), 3),
        }
        if best is None or rep["frames_per_s"] > best["frames_per_s"]:
            best = rep
    return best


async def one_client(cl: AsyncFrontendClient, reqs, lat, errors, window: int):
    """Drive one viewer: up to ``window`` requests in flight (a streaming
    client requests ahead of display, mirroring the engine's pipelined
    dispatch; window=1 is strict request-response lockstep)."""
    frames = 0
    inflight = []
    async def drain_one():
        nonlocal frames
        fut, t0 = inflight.pop(0)
        try:
            frame = await fut
            assert frame.ndim == 3
            frames += 1
            lat.append(time.perf_counter() - t0)
        except Exception as e:  # shed / remote error: counted, not fatal here
            errors.append(repr(e))

    for stream, t, cam in reqs:
        if len(inflight) >= window:
            await drain_one()
        inflight.append((await cl.submit_render(stream, cam, timestep=t), time.perf_counter()))
    while inflight:
        await drain_one()
    return frames


def aggregate_encoders(stats: dict) -> dict:
    """Fold per-session encoder stats into one wire-cost record (sessions
    vanish on disconnect, so this must run while the clients are live)."""
    keys = ("tiles_total", "tiles_shipped", "tiles_reffed", "tile_frames",
            "delta_frames", "raw_frames", "raw_fallbacks", "bytes_sent",
            "bytes_raw_equiv")
    tot = dict.fromkeys(keys, 0)
    for s in stats.get("sessions", {}).values():
        enc = s.get("encoder") or {}
        for k in keys:
            tot[k] += enc.get(k) or 0
    tot["tiles_shipped_frac"] = (
        round(tot["tiles_shipped"] / tot["tiles_total"], 4)
        if tot["tiles_total"] else None
    )
    tot["compression"] = (
        round(tot["bytes_raw_equiv"] / tot["bytes_sent"], 3)
        if tot["bytes_sent"] else None
    )
    return tot


async def drive_clients(host, port, trace, window) -> dict:
    """One measured lap: connect N clients, run the trace, disconnect."""
    clients = []
    for _ in trace:
        cl = AsyncFrontendClient(host, port)
        await cl.connect()
        clients.append(cl)
    try:
        lat, errors = [], []
        t0 = time.perf_counter()
        frames = await asyncio.gather(*[
            one_client(cl, reqs, lat, errors, window)
            for cl, reqs in zip(clients, trace)
        ])
        wall = time.perf_counter() - t0
        # wire-encoder stats live on the sessions: snapshot before disconnect
        wire = aggregate_encoders(await clients[0].stats())
        n = sum(len(r) for r in trace)
        return {
            "completed": int(sum(frames)),
            "submitted": n,
            "frames_per_s": round(sum(frames) / wall, 2),
            "p50_ms": round(_percentile([x * 1e3 for x in lat], 50), 3),
            "p99_ms": round(_percentile([x * 1e3 for x in lat], 99), 3),
            "client_errors": errors,
            "wire": wire,
        }
    finally:
        for cl in clients:
            await cl.close()




def config_from(args) -> None:
    """Set ``args``' knobs from ``--config-from`` (the tuner's
    recommendation), as ``benchmarks/frontend_load.py`` does; knobs this
    driver does not have (``cache_scale``) are ignored."""
    knobs = load_recommended_knobs(args.config_from)
    for knob, attr in (
        ("coalesce_ms", "coalesce_ms"), ("max_batch", "max_batch"),
        ("pipeline_depth", "pipeline_depth"), ("queue_limit", "queue_limit"),
        ("wave_per_session", "wave_per_session"),
    ):
        if knob in knobs:
            setattr(args, attr, type(getattr(args, attr))(knobs[knob]))
    print(f"config-from {args.config_from}: "
          f"coalesce_ms={args.coalesce_ms} max_batch={args.max_batch} "
          f"pipeline_depth={args.pipeline_depth} "
          f"queue_limit={args.queue_limit} "
          f"wave_per_session={args.wave_per_session}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    ap.add_argument("--dataset", default="kingsnake")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--volume-res", type=int, default=48)
    ap.add_argument("--max-points", type=int, default=3000)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8, help="requests per client")
    ap.add_argument("--timeline-steps", type=int, default=3)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--queue-limit", type=int, default=8)
    ap.add_argument("--wave-per-session", type=int, default=4)
    ap.add_argument("--coalesce-ms", type=float, default=2.0)
    ap.add_argument("--config-from", default=None, metavar="RECOMMEND.json",
                    help="knobs recommended by launch.tune (or a bare knob dict)")
    ap.add_argument("--client-window", type=int, default=2,
                    help="in-flight requests per client (1 = strict lockstep)")
    ap.add_argument("--no-delta", action="store_true")
    ap.add_argument("--min-ratio", type=float, default=0.75,
                    help="fail if network fps < ratio x in-process fps")
    ap.add_argument("--trace-out", default=None, metavar="PATH.jsonl",
                    help="run one extra traced lap, export its span trees as "
                         "JSONL + Chrome trace JSON, and gate the overhead")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="span ring size for the traced lap")
    ap.add_argument("--max-trace-overhead", type=float, default=0.5,
                    help="fail if the traced lap loses more than this "
                         "fraction of fps vs the slower untraced lap "
                         "(lenient: shared CI hosts are noisy)")
    ap.add_argument("--out", default="BENCH_frontend.json")
    args = ap.parse_args(argv)

    if args.config_from:
        config_from(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("frontend_load_torch: no CUDA device; pass --device cpu to run on the CPU")

    if args.smoke:
        args.res, args.volume_res, args.max_points = 32, 32, 800
        args.requests = min(args.requests, 6)
        # 32px toy frames render in ~3 ms, so the fixed per-message network
        # cost (~1.5 ms: two asyncio stacks + TCP on a shared 2-core host)
        # is comparable to the render itself; the fps-ratio criterion is
        # about production frame sizes (see --res 64 default), the smoke
        # gate is functional: zero shed, zero drops, zero protocol errors
        args.min_ratio = min(args.min_ratio, 0.3)

    params = init_params_from_volume(
        args.dataset, volume_res=args.volume_res, max_points=args.max_points
    )
    cfg = GSConfig(img_h=args.res, img_w=args.res, k_per_tile=128 if args.smoke else 256)
    n_dev = 1  # one card (or the CPU): the port's frontend fronts a one-device server

    manager = SessionManager(
        cfg, device=device, n_levels=args.levels, max_batch=args.max_batch,
        cache_capacity=512, store_frames=False, pipeline_depth=args.pipeline_depth,
    )
    manager.register_static("static", params)
    store = record_timeline(
        params, args.timeline_steps,
        os.path.join(tempfile.mkdtemp(prefix="frontend_bench_"), "seq"),
    )
    with store:
        timeline_stream(manager, "timeline", store)
    warm_s = manager.warmup()
    trace = build_trace(args)
    submitted = args.clients * args.requests

    # ---- in-process pipelined baseline (best of 2 cold-cache laps)
    rep_local = run_inprocess(manager, trace)

    # ---- identical trace over localhost TCP: clients in their OWN process
    # (like real remote viewers), best of 2 cold-cache laps. One unified
    # reset() windows every tier (server + cache + gateway + sessions) per
    # lap; the acceptance gates then sum the per-lap gateway snapshots, so
    # nothing shed or misframed in an early lap can hide behind a reset.
    manager.obs.metrics.reset()

    def _gw_counters(snapshot: dict) -> dict:
        return {
            k.split(".", 1)[1]: v for k, v in snapshot.items()
            if k.startswith("gateway.") and not isinstance(v, dict)
        }

    # per-lap histogram accumulation: bucket counts ADD across laps
    # (Histogram.merge), so the BENCH stages block describes every lap's
    # samples at full percentile fidelity — not just the best-timed lap
    hist_acc: dict[str, Histogram] = {}

    def _accumulate_hists(snapshot: dict) -> None:
        for k, v in snapshot.items():
            if isinstance(v, dict) and "counts" in v:
                if k in hist_acc:
                    hist_acc[k].merge(v)
                else:
                    hist_acc[k] = Histogram.from_dict(v, k)

    gateway = Gateway(
        manager, port=0, queue_limit=args.queue_limit,
        wave_per_session=args.wave_per_session,
        coalesce_ms=args.coalesce_ms,
        delta_encoding=not args.no_delta,
    )
    gt = GatewayThread(gateway).start()
    try:
        rep_net, laps, gw_laps = None, [], []
        for _ in range(2):
            # cold cache per lap, routed through the engine's single thread
            gateway.run_on_engine(manager.server.cache.drop, lambda k: True).result()
            rep = asyncio.run(
                drive_clients("127.0.0.1", gt.port, trace, args.client_window)
            )
            laps.append(rep)
            snap = manager.obs.metrics.snapshot()
            gw_laps.append(_gw_counters(snap))
            _accumulate_hists(snap)
            if rep_net is None or rep["frames_per_s"] > rep_net["frames_per_s"]:
                rep_net = rep
            gateway.run_on_engine(manager.obs.metrics.reset).result()

        # ---- optional third lap with span tracing live: same trace, fps
        # compared against the SLOWER untraced lap (overhead budget), span
        # trees exported as JSONL + Chrome trace JSON and re-validated
        trace_info = None
        if args.trace_out:
            manager.obs.enable_trace(args.trace_capacity)
            gateway.run_on_engine(manager.server.cache.drop, lambda k: True).result()
            rep_traced = asyncio.run(
                drive_clients("127.0.0.1", gt.port, trace, args.client_window)
            )
            laps.append(rep_traced)
            snap = manager.obs.metrics.snapshot()
            gw_laps.append(_gw_counters(snap))
            _accumulate_hists(snap)
            spans = manager.obs.trace.drain()
            dropped = manager.obs.trace.dropped
            # the knobs that produced this trace travel in the export header
            # so launch.tune replays against the real baseline configuration
            meta = trace_meta(manager.obs.trace, knobs={
                "coalesce_ms": args.coalesce_ms,
                "max_batch": args.max_batch,
                "pipeline_depth": args.pipeline_depth,
                "queue_limit": args.queue_limit,
                "wave_per_session": args.wave_per_session,
            })
            manager.obs.disable_trace()
            jsonl_path, chrome_path = write_trace(args.trace_out, spans, meta=meta)
            with open(jsonl_path) as f:
                n_spans = validate_trace_jsonl(f.read())
            floor_fps = min(lap["frames_per_s"] for lap in laps[:2])
            overhead = round(1.0 - rep_traced["frames_per_s"] / max(floor_fps, 1e-9), 3)
            trace_info = {
                "spans": int(n_spans), "dropped": dropped,
                "traced_frames_per_s": rep_traced["frames_per_s"],
                "traced_p50_ms": rep_traced["p50_ms"],
                "traced_p99_ms": rep_traced["p99_ms"],
                "overhead": overhead,
                "jsonl": jsonl_path, "chrome": chrome_path,
            }

        async def fetch_stats():
            cl = AsyncFrontendClient("127.0.0.1", gt.port)
            await cl.connect()
            try:
                return await cl.stats()
            finally:
                await cl.close()

        stats = asyncio.run(fetch_stats())
    finally:
        gt.stop()

    # acceptance-gate counters: sum of the per-lap windows
    gw = {}
    for lap_gw in gw_laps:
        for k, v in lap_gw.items():
            gw[k] = gw.get(k, 0) + v
    ratio = round(rep_net["frames_per_s"] / max(rep_local["frames_per_s"], 1e-9), 3)
    report = {
        "scene": {"dataset": args.dataset, "gaussians": params.n, "res": args.res},
        "devices": n_dev,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "streams": stats["streams"],
        "request_set": {
            "clients": args.clients, "requests_per_client": args.requests,
            "submitted": submitted,
        },
        "warmup_s": round(warm_s, 2),
        "inprocess": rep_local,
        "network": rep_net,
        "network_vs_inprocess": ratio,
        "gateway": gw,
        "wire": rep_net["wire"],
    }
    if trace_info:
        report["trace"] = trace_info
    print(json.dumps(report, indent=1))
    if args.out:
        write_bench(
            args.out, "frontend_load",
            config={
                "clients": args.clients, "requests_per_client": args.requests,
                "res": args.res, "gaussians": params.n, "devices": n_dev,
                "streams": len(stats["streams"]), "pipeline_depth": args.pipeline_depth,
                "queue_limit": args.queue_limit, "delta": not args.no_delta,
                "wave_per_session": args.wave_per_session,
                "coalesce_ms": args.coalesce_ms, "max_batch": args.max_batch,
                "config_from": args.config_from, "smoke": args.smoke,
            },
            metrics={
                "frames_per_s": rep_net["frames_per_s"],
                "p50_ms": rep_net["p50_ms"],
                "p99_ms": rep_net["p99_ms"],
                "inprocess_frames_per_s": rep_local["frames_per_s"],
                "network_vs_inprocess": ratio,
                "shed": gw["shed"],
                "protocol_errors": gw["protocol_errors"],
                "request_errors": gw["request_errors"],
                "dropped_writes": gw["dropped_writes"],
                "bytes_out": gw["bytes_out"],
                "wire_compression": rep_net["wire"]["compression"] or 0.0,
                "tiles_shipped_frac": rep_net["wire"]["tiles_shipped_frac"] or 0.0,
                "tile_frames": rep_net["wire"]["tile_frames"],
                "raw_fallbacks": rep_net["wire"]["raw_fallbacks"],
                **({"trace_spans": trace_info["spans"],
                    "trace_overhead": trace_info["overhead"],
                    # the traced lap's own measured numbers: the ones the
                    # replay harness (launch.tune --measured) calibrates
                    # against, since the exported spans describe THAT lap
                    "trace_frames_per_s": trace_info["traced_frames_per_s"],
                    "trace_p50_ms": trace_info["traced_p50_ms"],
                    "trace_p99_ms": trace_info["traced_p99_ms"]} if trace_info else {}),
            },
            # stages merged across every lap (histogram bucket counts add),
            # filtered through the same schema shape check as before
            stages=stage_breakdown(
                {k: h.snapshot() for k, h in sorted(hist_acc.items())}
            ),
        )

    # ---- hard acceptance over EVERY lap (not just the best-timed one):
    # nothing lost, nothing shed, nothing misframed
    for i, lap in enumerate(laps):
        if lap["completed"] != submitted:
            raise SystemExit(
                f"unshed drop in lap {i}: {lap['completed']} frames "
                f"of {submitted} submitted (shed={gw['shed']})"
            )
        if lap["client_errors"]:
            raise SystemExit(
                f"client errors in lap {i}: {lap['client_errors'][:3]}"
            )
    if gw["shed"]:
        raise SystemExit(f"load shed on an in-capacity trace: {gw['shed']}")
    if gw["protocol_errors"] or gw["request_errors"]:
        raise SystemExit(
            f"protocol/request errors: {gw['protocol_errors']}/{gw['request_errors']}"
        )
    if ratio < args.min_ratio:
        raise SystemExit(
            f"network fps {rep_net['frames_per_s']} < {args.min_ratio} x "
            f"in-process {rep_local['frames_per_s']}"
        )
    if trace_info:
        if trace_info["dropped"]:
            raise SystemExit(
                f"span ring overflowed: {trace_info['dropped']} spans dropped "
                f"(raise the recorder capacity)"
            )
        if trace_info["overhead"] > args.max_trace_overhead:
            raise SystemExit(
                f"tracing overhead {trace_info['overhead']} exceeds budget "
                f"{args.max_trace_overhead} (traced "
                f"{trace_info['traced_frames_per_s']} fps vs untraced floor)"
            )
        print(
            f"trace: {trace_info['spans']} spans -> {trace_info['jsonl']} + "
            f"{trace_info['chrome']} (overhead {trace_info['overhead']})"
        )
    print(
        f"frontend ok: {args.clients} clients x {args.requests} over 2 streams, "
        f"{rep_net['frames_per_s']} frames/s over TCP "
        f"({ratio}x in-process), p99 {rep_net['p99_ms']} ms, 0 shed/dropped"
    )


if __name__ == "__main__":
    main()
