"""Level-of-detail pyramid over a trained Gaussian model.

Serving far-away views with all 4M-18M Gaussians wastes compute: most splats
project to well under a pixel. The pyramid precomputes opacity/scale-pruned
subsets (LightGaussian-style importance = opacity x world-space area), so the
server composites a fraction of the model when the scene's screen coverage is
small. Level 0 is always the full model; each level keeps ``keep_ratio`` of
the previous level's live Gaussians, padded up to ``pad_quantum`` (with dead,
never-visible splats) so per-level jit shapes stay shard-aligned.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import gaussians as G
from repro_torch.core.projection import Camera, look_at_camera

# means/opacity used by the training pipeline to mark padded (dead) Gaussians
DEAD_MEAN = 1.0e6
DEAD_LOGIT = -20.0


class LODPyramid(NamedTuple):
    """Precomputed render-serving pyramid. ``levels[0]`` is the full model."""

    levels: tuple[G.GaussianModel, ...]  # host (numpy-leaf) models, coarsening
    live_counts: tuple[int, ...]         # live (non-padding) Gaussians per level
    scene_center: np.ndarray             # (3,) live-Gaussian centroid
    scene_extent: float                  # half-extent of the live bounding box

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def live_mask(g: G.GaussianModel, *, opacity_thresh: float = 1e-4) -> np.ndarray:
    """Gaussians that can ever contribute: finite, near the scene, not dead."""
    means = np.asarray(g.means)
    logit = np.asarray(g.opacity_logit)
    opac = 1.0 / (1.0 + np.exp(-np.clip(logit, -60, 60)))
    return (
        np.all(np.isfinite(means), axis=1)
        & (np.max(np.abs(means), axis=1) < DEAD_MEAN * 0.5)
        & (opac > opacity_thresh)
    )


def importance_scores(g: G.GaussianModel) -> np.ndarray:
    """Per-Gaussian serving importance: opacity x mean cross-section area.

    Large opaque splats dominate a low-coverage (far-away) view; tiny or
    near-transparent ones vanish first. This is the pruning metric from the
    compaction literature (opacity-volume product), in world units so it is
    view-independent and can be computed once at pyramid build time.
    """
    logit = np.asarray(g.opacity_logit, np.float64)
    opac = 1.0 / (1.0 + np.exp(-np.clip(logit, -60, 60)))
    mean_scale = np.exp(np.asarray(g.log_scales, np.float64)).mean(axis=1)
    return (opac * mean_scale**2).astype(np.float64)


def _pad_model(g_np: list[np.ndarray], n_target: int) -> G.GaussianModel:
    """Pad a host-side leaf list up to ``n_target`` with dead Gaussians."""
    means, log_scales, quats, opacity_logit, sh = g_np
    n = means.shape[0]
    pad = n_target - n
    if pad > 0:
        means = np.concatenate([means, np.full((pad, 3), DEAD_MEAN, np.float32)])
        log_scales = np.concatenate([log_scales, np.zeros((pad, 3), np.float32)])
        q = np.zeros((pad, 4), np.float32)
        q[:, 0] = 1.0
        quats = np.concatenate([quats, q])
        opacity_logit = np.concatenate([opacity_logit, np.full((pad,), DEAD_LOGIT, np.float32)])
        sh = np.concatenate([sh, np.zeros((pad,) + sh.shape[1:], np.float32)])
    return G.GaussianModel(means, log_scales, quats, opacity_logit, sh)


def build_lod_pyramid(
    params: G.GaussianModel,
    *,
    n_levels: int = 3,
    keep_ratio: float = 0.5,
    pad_quantum: int = 256,
    min_live: int = 32,
) -> LODPyramid:
    """Precompute the serving pyramid from a (possibly padded) trained model.

    Level k keeps the top ``keep_ratio**k`` fraction of live Gaussians by
    ``importance_scores``. Levels that would fall below ``min_live`` are not
    built (so tiny toy scenes get shallow pyramids instead of empty levels).
    """
    assert n_levels >= 1 and 0.0 < keep_ratio < 1.0
    leaves = [np.asarray(x, np.float32) for x in params]
    mask = live_mask(params)
    live_idx = np.nonzero(mask)[0]
    if live_idx.size == 0:
        raise ValueError("model has no live Gaussians to serve")
    live_means = leaves[0][live_idx]
    center = live_means.mean(axis=0)
    extent = float(np.max(np.abs(live_means - center))) or 1.0

    # rank live Gaussians once, most important first
    scores = importance_scores(params)[live_idx]
    ranked = live_idx[np.argsort(-scores, kind="stable")]

    levels: list[G.GaussianModel] = []
    counts: list[int] = []
    for k in range(n_levels):
        n_keep = max(int(round(live_idx.size * keep_ratio**k)), 1)
        if k > 0 and n_keep < min_live:
            break
        if k == 0:
            # full model verbatim (keeps training padding / sharding layout)
            levels.append(G.GaussianModel(*leaves))
            counts.append(int(live_idx.size))
            continue
        keep = np.sort(ranked[:n_keep])  # original order keeps locality
        sub = [x[keep] for x in leaves]
        n_padded = -(-n_keep // pad_quantum) * pad_quantum
        levels.append(_pad_model(sub, n_padded))
        counts.append(n_keep)
    return LODPyramid(tuple(levels), tuple(counts), center.astype(np.float32), extent)


def front_camera(pyr: LODPyramid, *, img_h: int, img_w: int, dist_factor: float = 3.0) -> Camera:
    """Canonical head-on framing of the pyramid's scene: the one default
    viewpoint shared by server warmup, smoke drivers, and examples."""
    center = pyr.scene_center
    eye = center + np.float32([0.0, 0.0, dist_factor * pyr.scene_extent])
    cam = look_at_camera(eye, center, [0.0, 1.0, 0.0], img_w, img_w, img_w / 2, img_h / 2)
    return Camera(*[np.asarray(x) for x in cam])


def screen_coverage(pyr: LODPyramid, cam: Camera, *, img_w: int) -> float:
    """Fraction of the image width the scene's bounding sphere spans."""
    campos = np.asarray(cam.campos, np.float64)
    dist = float(np.linalg.norm(campos - pyr.scene_center))
    dist = max(dist, 1e-6)
    fx = float(np.asarray(cam.fx))
    return (2.0 * pyr.scene_extent * fx / dist) / float(img_w)


def select_level(pyr: LODPyramid, cam: Camera, *, img_w: int) -> int:
    """Pick the pyramid level for a request from its screen coverage.

    Full coverage (>= 1) renders level 0; every halving of coverage drops one
    level — matching the keep_ratio=0.5 density halving, so the Gaussians per
    *covered pixel* stay roughly constant across distances.
    """
    cov = screen_coverage(pyr, cam, img_w=img_w)
    if cov >= 1.0:
        return 0
    lvl = int(np.floor(np.log2(1.0 / max(cov, 1e-9))))
    return min(max(lvl, 0), pyr.n_levels - 1)


def select_level_map(
    pyr: LODPyramid,
    cam: Camera,
    *,
    img_w: int,
    tiles_y: int,
    gaze_row: int | None = None,
    budget_rows: float | None = None,
    sharp_rows: int = 1,
    n_levels: int | None = None,
    keep_ratio: float = 0.5,
) -> tuple[int, ...]:
    """Per-tile-row LOD assignment: gaze rows sharp, peripheral rows coarse.

    Generalizes :func:`select_level` from one level per frame to one level
    per tile row. The coverage-derived level is the *floor* everywhere; rows
    farther than ``sharp_rows`` from the gaze row coarsen one level per row
    of distance (clamped to the pyramid depth ``n_levels``, which callers
    pass as the actual built depth when shallower than ``pyr.n_levels``).

    ``budget_rows`` is an approximate render budget in full-detail-row
    units: rendering a row at level l costs ~``keep_ratio**l`` of a level-0
    row (the pyramid keeps that fraction of Gaussians). When set, the
    sharp-zone half-width shrinks until the summed cost fits — gracefully
    degrading the periphery first, never the gaze row. With neither a gaze
    hint nor a budget the map is uniform at the coverage level, matching the
    legacy whole-frame behaviour bit for bit.
    """
    n = int(n_levels if n_levels is not None else pyr.n_levels)
    base = min(select_level(pyr, cam, img_w=img_w), n - 1)
    if n <= 1 or (gaze_row is None and budget_rows is None):
        return (base,) * tiles_y
    g = tiles_y // 2 if gaze_row is None else min(max(int(gaze_row), 0), tiles_y - 1)

    def profile(s: int) -> tuple[int, ...]:
        return tuple(min(base + max(abs(r - g) - s, 0), n - 1) for r in range(tiles_y))

    if budget_rows is None:
        return profile(max(int(sharp_rows), 0))
    # widest sharp zone whose estimated cost fits the budget (s = tiles_y is
    # the uniform-sharp frame, s = 0 degrades everything but the gaze row)
    cost = lambda p: sum(keep_ratio**l for l in p)
    for s in range(tiles_y, -1, -1):
        p = profile(s)
        if cost(p) <= budget_rows:
            return p
    return profile(0)
