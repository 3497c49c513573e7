"""Minimal image IO (PPM — no imaging dependencies needed); the port's copy
of the JAX package's ``utils/image.py``."""
from __future__ import annotations

import numpy as np


def write_ppm(path: str, img) -> None:
    """Write an (H, W, 3) float image in [0, 1] as binary PPM (P6). ``img``
    is an array or a tensor (on any device)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    arr = np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode())
        f.write(arr.tobytes())
