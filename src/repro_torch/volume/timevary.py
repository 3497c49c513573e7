"""Time-varying synthetic volumes + the ``VolumeStream`` source protocol.

The paper's conclusion targets "real-time post hoc and in situ visualization
of complex simulations": the volume is no longer a static dump but a sequence
of evolving timesteps. These generators extend ``repro_torch.volume.datasets`` in
time — a Kingsnake coil that uncoils and a Miranda mixing layer that grows —
with fields that are *continuous in t*, so adjacent timesteps differ by a
small perturbation and a warm-started Gaussian model can track the surface.

``VolumeStream`` abstracts where timesteps come from:

  * ``CallbackStream``  — in-situ: the "simulation" is a callable t -> field,
    evaluated lazily as the trainer consumes it (nothing hits disk).
  * ``DiskStream``      — post hoc: timesteps previously written by
    ``dump_stream`` are read back from ``t_####.npz`` files.

Both yield plain ``VolumeSpec`` values, so every downstream stage (isosurface
extraction, GT raymarch, training) is source-agnostic.
"""
from __future__ import annotations

import json
import os
import re
from typing import Callable, Iterator, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.volume.datasets import VolumeSpec, _grid


@runtime_checkable
class VolumeStream(Protocol):
    """A finite, ordered sequence of evolving volume timesteps."""

    name: str

    def __len__(self) -> int: ...

    def __iter__(self) -> Iterator[VolumeSpec]: ...


# --------------------------------------------------------------- generators
def kingsnake_uncoil(
    t: float, *, res: int = 64, extent: float = 1.0, coils: float = 3.5
) -> VolumeSpec:
    """Kingsnake coil at simulation time ``t`` in [0, 1]: the helix uncoils.

    As t grows the total twist drops (fewer windings), the helix radius
    relaxes outward and the body stretches along z — a snake slowly
    straightening. The centerline moves continuously in t, and the field is
    a smooth function (distance to the centerline) of it, so
    ``|field(t+dt) - field(t)| -> 0`` with dt: exactly the regime warm-start
    incremental training assumes.
    """
    t = float(np.clip(t, 0.0, 1.0))
    x, y, z = _grid(res, extent)
    n_coils = coils * (1.0 - 0.45 * t)          # uncoiling: fewer windings
    tt = np.linspace(0, 2 * np.pi * n_coils, 400, dtype=np.float32)
    s = tt / tt[-1]                              # arclength-ish parameter in [0,1]
    r_helix = (0.55 + 0.10 * t) * (1.0 - 0.12 * s)
    hx = r_helix * np.cos(tt)
    hy = r_helix * np.sin(tt)
    hz = np.linspace(-(0.7 + 0.15 * t) * extent, (0.7 + 0.15 * t) * extent, tt.size, dtype=np.float32)
    pts = np.stack([hx, hy, hz], 1)

    vox = np.stack([x, y, z], -1).reshape(-1, 3)
    d = np.full((vox.shape[0],), np.inf, np.float32)
    for i in range(0, pts.shape[0], 50):
        seg = pts[i : i + 50]
        dd = np.linalg.norm(vox[:, None, :] - seg[None], axis=-1).min(1)
        d = np.minimum(d, dd)
    d = d.reshape(res, res, res)
    tex = 0.015 * np.sin(7.0 * x) * np.cos(6.0 * y) * np.sin(5.0 * z)
    field = d - (0.16 + tex)
    return VolumeSpec(field.astype(np.float32), 0.0, extent, f"kingsnake_uncoil_t{t:.3f}")


def miranda_growth(
    t: float, *, res: int = 64, extent: float = 1.0, modes: int = 6, seed: int = 1
) -> VolumeSpec:
    """Miranda mixing layer at time ``t`` in [0, 1]: the instability grows.

    The multi-mode displacement amplitude ramps up with t (mixing-layer
    width growth) while the mode phases drift slowly (structures translate),
    matching the qualitative evolution of a Rayleigh-Taylor interface.
    """
    t = float(np.clip(t, 0.0, 1.0))
    x, y, z = _grid(res, extent)
    rng = np.random.default_rng(seed)
    grow = 0.35 + 0.65 * t                       # amplitude ramp
    disp = np.zeros_like(x)
    for _ in range(modes):
        kx, ky = rng.uniform(2.0, 9.0, 2)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.04, 0.14)
        disp += grow * amp * np.sin(kx * x + ph1 + 0.6 * t) * np.cos(ky * y + ph2 + 0.4 * t)
    disp += grow * 0.08 * np.sin(4.0 * x) * np.sin(4.0 * y) * np.cos(3.0 * z)
    field = z - disp
    return VolumeSpec(field.astype(np.float32), 0.0, extent, f"miranda_growth_t{t:.3f}")


GENERATORS: dict[str, Callable[..., VolumeSpec]] = {
    "kingsnake": kingsnake_uncoil,
    "miranda": miranda_growth,
}


# ------------------------------------------------------------------ sources
class CallbackStream:
    """In-situ source: a callable ``fn(t, **kw) -> VolumeSpec`` sampled at
    ``times``. The simulation side of an in-situ coupling is exactly such a
    callback — nothing is materialized until the trainer pulls a timestep."""

    def __init__(self, fn: Callable[..., VolumeSpec], times: Sequence[float], *, name: str, **kw):
        self.fn = fn
        self.times = [float(t) for t in times]
        self.name = name
        self.kw = kw

    def __len__(self) -> int:
        return len(self.times)

    def __iter__(self) -> Iterator[VolumeSpec]:
        for t in self.times:
            yield self.fn(t, **self.kw)


def synthetic_stream(
    dataset: str, n_timesteps: int, *, res: int = 48, t0: float = 0.0, t1: float = 0.5, **kw
) -> CallbackStream:
    """Evenly-sampled in-situ stream of one of the named generators."""
    fn = GENERATORS[dataset]
    times = np.linspace(t0, t1, n_timesteps)
    return CallbackStream(fn, times, name=dataset, res=res, **kw)


class DiskStream:
    """Post-hoc source: timesteps read back from ``<dir>/t_####.npz`` dumps
    (written by ``dump_stream``), the on-disk layout a simulation's I/O stage
    would leave behind."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, "stream.json")) as f:
            meta = json.load(f)
        self.name = meta["name"]
        self._files = [
            os.path.join(directory, n)
            for n in sorted(
                (n for n in os.listdir(directory) if re.match(r"t_\d+\.npz$", n)),
                key=lambda n: int(n[2:-4]),  # numeric: lexicographic breaks past t_9999
            )
        ]

    def __len__(self) -> int:
        return len(self._files)

    def __iter__(self) -> Iterator[VolumeSpec]:
        for path in self._files:
            with np.load(path) as z:
                yield VolumeSpec(
                    z["field"].astype(np.float32),
                    float(z["isovalue"]),
                    float(z["extent"]),
                    str(z["name"]),
                )


def dump_stream(stream: VolumeStream, directory: str) -> list[str]:
    """Write a stream to disk in the ``DiskStream`` layout; returns paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, vol in enumerate(stream):
        path = os.path.join(directory, f"t_{i:04d}.npz")
        np.savez_compressed(
            path, field=vol.field, isovalue=vol.isovalue, extent=vol.extent, name=vol.name
        )
        paths.append(path)
    with open(os.path.join(directory, "stream.json"), "w") as f:
        json.dump({"name": stream.name, "n_timesteps": len(paths)}, f)
    return paths
