"""In situ streaming reconstruction with the PyTorch port (the mirror of
``examples/insitu_timeseries.py``).

A simulation produces a time-evolving volume; instead of writing full volume
dumps (the I/O burden the paper wants to avoid), each timestep is absorbed
into one fixed-capacity Gaussian model WARM-STARTED from the previous step:
few optimization steps per timestep, one train-step shape for the whole
sequence. This is ``repro_torch.insitu`` end to end on the card: an in situ
callback stream, the incremental trainer, temporal (keyframe + quantized
delta) checkpoints, and a time-scrubbing render across the stored sequence.
``--device cpu`` runs the plain PyTorch versions instead; ``--smoke`` cuts it
to 32 px, 2 timesteps and a few steps.

  PYTHONPATH=src python examples/insitu_timeseries_torch.py
  PYTHONPATH=src python examples/insitu_timeseries_torch.py --device cpu --smoke
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core.config import GSConfig
from repro_torch.insitu import InsituTrainer, TemporalCheckpointStore, build_timeline_server, scrub
from repro_torch.serve_gs import front_camera
from repro_torch.volume.timevary import synthetic_stream


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device to train and serve on (default: the card)")
    ap.add_argument("--smoke", action="store_true", help="32 px, 2 timesteps, 6 cold and 3 warm steps")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    H = 32 if args.smoke else 48
    n_t, cold, warm = (2, 6, 3) if args.smoke else (4, 60, 15)
    cfg = GSConfig(
        img_h=H, img_w=H, batch_size=2, k_per_tile=128, max_steps=200,
        densify_from=10**9, opacity_reset_interval=10**9,
    )

    # the "simulation": a Miranda-like mixing layer growing over the timesteps
    stream = synthetic_stream("miranda", n_t, res=32, t1=0.2)
    store = TemporalCheckpointStore(
        os.path.join(tempfile.mkdtemp(prefix="insitu_example_"), "seq"), keyframe_interval=4
    )
    trainer = InsituTrainer(
        cfg, device=args.device, cold_steps=cold, warm_steps=warm, n_views=6,
        max_points=800, n_steps_raymarch=48, init_scale=0.06, verbose=True,
    )
    trainer.run(stream, store=store)
    print(f"train-step shape signatures across the sequence: {trainer.n_traces} (fixed capacity -> 1)")
    print(f"temporal store: {store.stats()}")

    # post hoc time-scrub: one camera, every stored timestep
    server = build_timeline_server(store, cfg, n_levels=2, max_batch=2, device=args.device)
    cam = front_camera(server.pyramid, img_h=H, img_w=H)
    frames = scrub(server, cam, store.timesteps())
    for t, frame in frames.items():
        print(f"  t={t}: frame {frame.shape}, surface pixels {(frame.sum(-1) > 0.01).mean():.1%}")
    store.close()


if __name__ == "__main__":
    main()
