"""Network gateway driver (PyTorch port): serve trained Gaussian models over TCP.

Registers one or more streams — a static scene (checkpoint or synthetic
isosurface) and, optionally, a `TemporalCheckpointStore` insitu sequence as a
scrubbable timeline — on one shared render-server pool, then listens for
frontend-protocol clients (``FrontendClient`` of either package: the wire
format is the JAX package's). Serves on the card by default and raises when
there is none; ``--device cpu`` serves through the plain PyTorch versions.

  # serve a synthetic scene + a 3-step synthetic timeline, verify with an
  # in-process client, print the gateway report, exit
  PYTHONPATH=src python -m repro_torch.launch.frontend --smoke --device cpu

  # serve a trained checkpoint and a recorded insitu run until Ctrl-C
  PYTHONPATH=src python -m repro_torch.launch.frontend --port 7070 \\
      --ckpt experiments/ckpts/run0 --insitu-store experiments/insitu/run0/seq
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.gs_datasets import DATASETS
from repro_torch.core.config import GSConfig
from repro_torch.core.projection import look_at_camera
from repro_torch.frontend import FrontendClient, Gateway, GatewayThread, SessionManager
from repro_torch.insitu import TemporalCheckpointStore, timeline_stream
from repro_torch.launch.serve_gs import init_params_from_volume, load_params_from_ckpt
from repro_torch.obs import Obs, export_trace, parse_slo_spec


def synthetic_timeline(params, n_steps: int, *, drift: float = 0.08) -> dict:
    """A tiny in-memory timeline: the static scene drifting along +x. Stands
    in for a recorded insitu sequence when none is given (smoke/self-test).
    The shift is the JAX package's float32 vector, so both packages' means
    agree bit for bit."""
    return {
        t: params._replace(means=params.means + torch.from_numpy(
            np.float32(drift * t) * np.float32([1, 0, 0])).to(params.means.device))
        for t in range(n_steps)
    }


def self_test(host: str, port: int, *, scrub_stream: str | None) -> dict:
    """Connect like a real remote viewer; one render per stream + a scrub,
    plus one foveated render (gaze hint) exercising the per-tile LOD path."""
    with FrontendClient(host, port) as cl:
        h, w = cl.hello["img_h"], cl.hello["img_w"]
        cam_by_stream = {}
        rendered = {}
        for sid, info in cl.streams.items():
            # a front camera needs scene geometry the client doesn't have;
            # a fixed orbit-ish pose works for any normalized scene
            cam = look_at_camera([0, 0, -3.0], [0, 0, 0], [0, 1, 0], w * 1.2, w * 1.2, w / 2, h / 2)
            cam_by_stream[sid] = cam
            frame = cl.render(sid, cam, timestep=info["timesteps"][0])
            rendered[sid] = list(frame.shape)
            if frame.shape != (h, w, 3) or frame.dtype != np.uint8:
                raise RuntimeError(f"frame of {sid}: {frame.shape} {frame.dtype}")
        # foveated render: gaze at the top edge so the lower rows coarsen
        sid0, info0 = next(iter(cl.streams.items()))
        fov = cl.render(sid0, cam_by_stream[sid0], timestep=info0["timesteps"][0], gaze=(0.5, 0.0))
        if fov.shape != (h, w, 3):
            raise RuntimeError(f"foveated frame: {fov.shape}")
        scrubbed = 0
        if scrub_stream is not None:
            ts = cl.streams[scrub_stream]["timesteps"]
            frames = cl.scrub(scrub_stream, cam_by_stream[scrub_stream], ts)
            scrubbed = len(frames)
            if sorted(frames) != sorted(ts):
                raise RuntimeError(f"scrub answered {sorted(frames)}, asked {sorted(ts)}")
        stats = cl.stats()
    return {"rendered": rendered, "scrubbed": scrubbed, "stats": stats}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small config + in-process client self-test, then exit")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7070, help="0 = ephemeral")
    # static stream source
    ap.add_argument("--ckpt", default=None, help="checkpoint dir written by either package's training CLI")
    ap.add_argument("--dataset", choices=list(DATASETS), default="kingsnake")
    ap.add_argument("--volume-res", type=int, default=48)
    ap.add_argument("--max-points", type=int, default=4000)
    # timeline stream source
    ap.add_argument("--insitu-store", default=None,
                    help="TemporalCheckpointStore dir -> scrubbable 'timeline' stream")
    ap.add_argument("--synthetic-timeline", type=int, default=0,
                    help="N>0: register an N-step synthetic drift timeline")
    # serving engine
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--keep-ratio", type=float, default=0.5)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache", type=int, default=512,
                    help="cache capacity in frame-equivalents (byte budget)")
    ap.add_argument("--frame-cache", action="store_true",
                    help="whole-frame cache baseline (no tile granularity)")
    ap.add_argument("--pipeline-depth", type=int, default=2)
    # gateway
    ap.add_argument("--queue-limit", type=int, default=8,
                    help="per-session bounded queue (overflow sheds oldest)")
    ap.add_argument("--wave-per-session", type=int, default=4)
    ap.add_argument("--no-delta", action="store_true",
                    help="disable zlib delta frame encoding (always raw RGB8)")
    ap.add_argument("--serve-seconds", type=float, default=0.0,
                    help="serve for N seconds then exit (0 = until Ctrl-C)")
    # observability
    ap.add_argument("--trace-out", default=None, metavar="PATH.jsonl",
                    help="record request span traces; on exit write JSONL "
                         "here plus a Perfetto-viewable .chrome.json next to it")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="span ring size (oldest spans drop beyond this)")
    ap.add_argument("--slo", default=None, metavar="p99_ms=N[,window_s=S,budget=B]",
                    help="live SLO tracking on served latency; state "
                         "(ok/warn/breach + budget burn) shows up in the "
                         "stats and metrics wire messages")
    args = ap.parse_args(argv)
    slo_kw = parse_slo_spec(args.slo) if args.slo else None

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("frontend: no CUDA device; pass --device cpu to serve on the CPU")
    if args.smoke:
        args.res = min(args.res, 32)
        args.volume_res = min(args.volume_res, 32)
        args.max_points = min(args.max_points, 800)
        args.levels = min(args.levels, 2)
        args.port = 0  # never collide in CI
        if args.insitu_store is None and args.synthetic_timeline == 0:
            args.synthetic_timeline = 3

    if args.ckpt:
        params = load_params_from_ckpt(args.ckpt)
    else:
        params = init_params_from_volume(
            args.dataset, volume_res=args.volume_res, max_points=args.max_points
        )
    cfg = GSConfig(img_h=args.res, img_w=args.res, k_per_tile=128 if args.smoke else 256)

    obs = Obs(trace=args.trace_out is not None, trace_capacity=args.trace_capacity)
    manager = SessionManager(
        cfg,
        obs=obs,
        device=device,
        n_levels=args.levels,
        keep_ratio=args.keep_ratio,
        max_batch=args.max_batch,
        cache_capacity=args.cache,
        tile_cache=not args.frame_cache,
        store_frames=False,
        pipeline_depth=args.pipeline_depth,
    )
    manager.register_static("static", params)
    scrub_stream = None
    if args.insitu_store:
        with TemporalCheckpointStore(args.insitu_store) as store:
            timeline_stream(manager, "timeline", store)
        scrub_stream = "timeline"
    elif args.synthetic_timeline > 0:
        manager.register_timeline("timeline", synthetic_timeline(params, args.synthetic_timeline))
        scrub_stream = "timeline"
    warm_s = manager.warmup()

    gateway = Gateway(
        manager,
        host=args.host,
        port=args.port,
        queue_limit=args.queue_limit,
        wave_per_session=args.wave_per_session,
        delta_encoding=not args.no_delta,
        slo=slo_kw,
    )
    gt = GatewayThread(gateway).start()
    try:
        print(
            f"frontend listening on {args.host}:{gateway.port} "
            f"streams={list(manager.streams)} warmup={warm_s:.1f}s device={device} "
            f"(client: repro_torch.frontend.FrontendClient('{args.host}', {gateway.port}))",
            flush=True,
        )
        if args.smoke:
            out = self_test(args.host, gateway.port, scrub_stream=scrub_stream)
            print(json.dumps(out, indent=1))
            gw = out["stats"]["gateway"]
            if gw["protocol_errors"] or gw["shed"] or gw["frames_sent"] < len(manager.streams):
                raise SystemExit(f"frontend smoke failed: {gw}")
            # per-tile LOD accounting reached the report (foveated or uniform,
            # every request assigns each tile row a level)
            lod = out["stats"]["server"]["lod"]
            if sum(lod["rows_per_level"]) <= 0:
                raise SystemExit(f"frontend smoke: no tile rows served by level: {lod}")
            print(f"frontend smoke ok: {gw['frames_sent']} frames over TCP, "
                  f"{gw['bytes_out']} bytes, 0 shed, device {device}")
        elif args.serve_seconds > 0:
            time.sleep(args.serve_seconds)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        gt.stop()
        if args.trace_out:
            # the knobs ride in the export header: a later tuning run
            # replays against the exact configuration that produced the trace
            export_trace(obs.trace, args.trace_out, {
                "coalesce_ms": gateway.coalesce_ms,
                "max_batch": args.max_batch,
                "pipeline_depth": args.pipeline_depth,
                "queue_limit": args.queue_limit,
                "wave_per_session": args.wave_per_session,
            })


if __name__ == "__main__":
    main()
