"""View data pipeline: GT render cache + shuffled batch iterator.

Copy of the JAX package's ``data/views.py``. The paper trains against 448
synthetic orbit views; rendering those GT images (ray-marched isosurface) is
expensive, so they are produced once and cached on disk, under the JAX
package's file names, so that both packages can train on identical images.
The batch order comes from the same numpy generator algorithm, so both
packages draw the same views for the same seed.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.volume.cameras import camera_slice, orbit_cameras
from repro_torch.volume.datasets import VolumeSpec
from repro_torch.volume.raymarch import render_isosurface


class ViewDataset:
    """Orbit cameras (host tensors) and their GT images. Images are rendered
    on ``device`` (default: the card) and handed out on it; the numpy copy
    is ``self.gt``."""

    def __init__(
        self,
        vol: VolumeSpec,
        *,
        n_views: int,
        img_h: int,
        img_w: int,
        radius: float = 3.0,
        cache_dir: str | None = None,
        n_steps_raymarch: int = 128,
        seed: int = 0,
        device="cuda",
    ):
        self.img_h, self.img_w = img_h, img_w
        self.n_views = n_views
        self.device = torch.device(device)
        self.cams = orbit_cameras(n_views, img_h=img_h, img_w=img_w, radius=radius)
        self.rng = np.random.default_rng(seed)

        cache_file = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cache_file = os.path.join(cache_dir, f"{vol.name}_{n_views}v_{img_h}x{img_w}.npy")
        if cache_file and os.path.exists(cache_file):
            self.gt = np.load(cache_file)
        else:
            field = torch.as_tensor(vol.field).to(self.device)
            imgs = [
                render_isosurface(
                    field, vol.isovalue, camera_slice(self.cams, i),
                    img_h=img_h, img_w=img_w, extent=vol.extent, n_steps=n_steps_raymarch,
                ).cpu().numpy()
                for i in range(n_views)
            ]
            self.gt = np.stack(imgs).astype(np.float32)
            if cache_file:
                np.save(cache_file, self.gt)
        self._gt_dev = torch.as_tensor(self.gt).to(self.device)

    def batches(self, batch_size: int, *, steps: int):
        """Yield (Camera batch, gt batch) `steps` times (with replacement
        across epochs, without within an epoch — 3D-GS convention). When an
        epoch runs low the next permutation is *prepended*, so the leftover
        views are still drawn before any view repeats: every view is sampled
        exactly once per epoch. At the epoch seam a draw that would duplicate
        a view already in the batch is swapped deeper into the new
        permutation (possible whenever batch_size <= n_views)."""
        order = []
        for _ in range(steps):
            sel = []
            for _ in range(batch_size):
                if not order:
                    order = list(self.rng.permutation(self.n_views))
                if order[-1] in sel:
                    for j in range(len(order) - 1):
                        if order[j] not in sel:
                            order[-1], order[j] = order[j], order[-1]
                            break
                sel.append(order.pop())
            idx = torch.as_tensor(np.asarray(sel, np.int64))
            yield camera_slice(self.cams, idx), self._gt_dev[idx.to(self.device)]

    def view(self, i: int):
        return camera_slice(self.cams, i), self._gt_dev[i]
