"""GS dataset configs mirroring the paper's two benchmarks.

Paper: Kingsnake (110 MB volume, ~4M isosurface points) and Miranda (491 MB,
~18.18M points), 448 orbit views, image resolutions 512/1024/2048, trained on
1/2/4 A100s. The synthetic stand-ins reproduce the structural regime at
configurable scale; `paper_scale=True` requests the full point counts (used
by the dry-run/roofline paths, which never materialize them).

``paper_scene`` (the port's own) materializes them: a model at the paper's
Gaussian count on a stand-in volume, for the card runs of the paper's
tables and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import gaussians as G
from repro_torch.core.config import GSConfig
from repro_torch.volume import datasets as VD
from repro_torch.volume.isosurface import extract_isosurface_points


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


def paper_scene(dataset: str, n_points: int, seed: int, *, vol=None):
    """Host model of ``n_points`` Gaussians on ``dataset``'s isosurface, and
    the number of surface points it was grown from, and the volume.

    The synthetic volume (``vol``, by default made at the dataset's
    resolution) is extracted, and each surface point is replicated with
    sub-voxel jitter until ``n_points`` is reached (the paper's counts:
    Kingsnake 4,000,000, Miranda 18,180,000); the init scale shrinks with
    the replication so the surface keeps its coverage. Rotations,
    anisotropy and opacities are drawn from ``seed`` (random weights, as a
    trained model would vary)."""
    ds = DATASETS[dataset]
    if vol is None:
        vol = getattr(VD, ds.volume)(res=ds.volume_res)
    pts, _, cols = extract_isosurface_points(vol)
    rng = np.random.default_rng(seed)
    spacing = 2.0 * vol.extent / (vol.field.shape[0] - 1)
    rep = n_points / pts.shape[0]
    src = np.arange(n_points) % pts.shape[0]
    means = (pts[src] + rng.uniform(-0.5, 0.5, (n_points, 3)) * spacing).astype(np.float32)
    g = G.to_numpy(G.init_from_points(means, cols[src], init_scale=0.5 * spacing / math.sqrt(rep), device="cpu"))
    g = g._replace(
        log_scales=(g.log_scales + rng.normal(0.0, 0.3, (n_points, 3))).astype(np.float32),
        quats=rng.normal(0.0, 1.0, (n_points, 4)).astype(np.float32),
        opacity_logit=(g.opacity_logit + rng.normal(0.0, 0.5, n_points)).astype(np.float32),
    )
    return g, pts.shape[0], vol


def pad_dead(g, quantum: int, *, init_scale=None):
    """Host model ``g`` padded with dead Gaussians to a multiple of
    ``quantum``: far away (1e6), zero color, opacity logit ``DEAD_LOGIT``
    (-20), seeded by ``init_from_points`` at ``init_scale`` (its heuristic
    when None), as ``GSTrainer`` pads isosurface points."""
    from repro_torch.core.densify import DEAD_LOGIT

    pad = (-g.means.shape[0]) % quantum
    if pad == 0:
        return g
    dead = G.to_numpy(G.init_from_points(np.full((pad, 3), 1e6, np.float32), np.zeros((pad, 3), np.float32),
                                         init_scale=init_scale, device="cpu"))
    dead = dead._replace(opacity_logit=np.full(pad, DEAD_LOGIT, np.float32))
    return G.GaussianModel(*[np.concatenate([a, b]) for a, b in zip(g, dead)])
