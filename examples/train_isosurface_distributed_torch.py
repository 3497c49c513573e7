"""End-to-end driver of the PyTorch port: distributed training of an
isosurface Gaussian model for a few hundred steps, with densification,
checkpointing and final metrics (the mirror of
``examples/train_isosurface_distributed.py``, with the same defaults).

One process per rank, under torchrun: NCCL with one rank per card, or gloo
on the CPU with ``--device cpu``. Two model-axis ranks on the CPU:

  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      examples/train_isosurface_distributed_torch.py --device cpu --model-par 2

and on two cards, ``--model-par 2`` without ``--device cpu``. With no
arguments it trains on one card. The defaults below come first, so any
argument given overrides them. (Equivalent to ``python -m
repro_torch.launch.train``, kept here as the runnable example entry point.)
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    sys.argv[1:1] = [
        "--dataset", "miranda", "--volume-res", "48", "--max-points", "8000",
        "--res", "64", "--steps", "300", "--views", "24", "--ckpt", "experiments/ckpts/miranda_demo_torch",
    ]
    main()
