"""Configuration for 3D-GS rendering and training (the paper's pipeline).

Same fields and defaults as the JAX package's ``GSConfig``, so one config
value means the same thing in both packages. ``backend`` is carried for that
reason only: the port picks the plain PyTorch version or the hand-written
CUDA kernel by the device of the tensors it is given, never by this field.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GSConfig:
    # image / rasterization
    img_h: int = 512
    img_w: int = 512
    tile_h: int = 16
    tile_w: int = 16
    k_per_tile: int = 256
    backend: str = "ref"            # JAX-side switch; the port dispatches by tensor device
    binning: str = "auto"           # "flat" | "hier" | "auto" (hier when tiles>=256)
    bg: tuple[float, float, float] = (0.0, 0.0, 0.0)
    sh_degree: int = 0

    # training
    batch_size: int = 4             # global views per step
    max_steps: int = 30_000
    lambda_dssim: float = 0.2
    lr_means_init: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_sh: float = 2.5e-3
    grendel_sqrt_lr_scaling: bool = True  # Grendel batched-view LR rule

    # densification (3D-GS schedule, host-side between jitted segments)
    densify_from: int = 500
    densify_until: int = 15_000
    densify_interval: int = 100
    densify_grad_thresh: float = 2e-4  # on view-space mean2d grad norm
    densify_scale_thresh: float = 0.01  # split-vs-clone world-size boundary (x scene extent)
    prune_opacity_thresh: float = 0.005
    opacity_reset_interval: int = 3000

    # distribution
    pixel_parallel: bool = True     # strip-shard pixels over the model axis
    pad_quantum: int = 256          # gaussian count padding unit per shard
    # what crosses the interconnect from Gaussian owners to renderers:
    #   "projected" — Grendel/paper-faithful: 11-float 2D splats, per view
    #   "params3d"  — beyond-paper: the 14-float 3D state ONCE per step,
    #                 projection recomputed locally (wins for batch >= 2:
    #                 B*44 bytes vs 56 bytes per gaussian; §Perf GS log)
    gather_mode: str = "projected"

    def lr_tree_dict(self) -> dict:
        return {
            "means": self.lr_means_init,
            "log_scales": self.lr_scales,
            "quats": self.lr_quats,
            "opacity_logit": self.lr_opacity,
            "sh": self.lr_sh,
        }
