"""GS dataset configs mirroring the paper's two benchmarks.

Paper: Kingsnake (110 MB volume, ~4M isosurface points) and Miranda (491 MB,
~18.18M points), 448 orbit views, image resolutions 512/1024/2048, trained on
1/2/4 A100s. The synthetic stand-ins reproduce the structural regime at
configurable scale; `paper_scale=True` requests the full point counts (used
by the dry-run/roofline paths, which never materialize them).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.config import GSConfig


@dataclasses.dataclass(frozen=True)
class GSDataset:
    name: str
    volume: str              # "kingsnake_like" | "miranda_like"
    volume_res: int
    n_views: int
    max_points: int | None
    paper_points: int        # the paper's reported Gaussian count
    radius: float = 3.0


KINGSNAKE = GSDataset(
    name="kingsnake", volume="kingsnake_like", volume_res=96,
    n_views=448, max_points=None, paper_points=4_000_000,
)
MIRANDA = GSDataset(
    name="miranda", volume="miranda_like", volume_res=96,
    n_views=448, max_points=None, paper_points=18_180_000,
)

DATASETS = {"kingsnake": KINGSNAKE, "miranda": MIRANDA}


def paper_gs_config(resolution: int = 512, **overrides) -> GSConfig:
    return GSConfig(
        img_h=resolution, img_w=resolution,
        batch_size=overrides.pop("batch_size", 4),
        **overrides,
    )
