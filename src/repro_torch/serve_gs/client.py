"""Synthetic multi-client load harness for the render server.

Simulates N viewers exploring a trained scene: each client walks an orbit
(``volume/cameras.py``) at its own radius/stride, submitting one request
per round at a configurable rate. Clients sharing an orbit revisit quantized
poses, exercising the frame cache; clients at large radii exercise coarse LOD
levels. Everything is deterministic (seeded phases), so throughput runs are
reproducible.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.projection import Camera
from repro_torch.volume.cameras import camera_slice, orbit_cameras


class OrbitClient:
    """One synthetic viewer stepping along a shared or private orbit."""

    def __init__(
        self,
        client_id: int,
        *,
        n_views: int,
        img_h: int,
        img_w: int,
        radius: float = 3.0,
        phase: int = 0,
        stride: int = 1,
    ):
        self.client_id = client_id
        self.n_views = n_views
        self.stride = stride
        self._i = phase % n_views
        self._cams = orbit_cameras(n_views, img_h=img_h, img_w=img_w, radius=radius)

    def next_camera(self) -> Camera:
        cam = camera_slice(self._cams, self._i % self.n_views)
        self._i += self.stride
        return Camera(*[np.asarray(x) for x in cam])


def make_clients(
    n_clients: int,
    *,
    n_views: int,
    img_h: int,
    img_w: int,
    base_radius: float = 3.0,
    radius_spread: float = 0.0,
    shared_orbit: bool = True,
    dup_pairs: bool = False,
) -> list[OrbitClient]:
    """Build a deterministic client fleet.

    ``shared_orbit`` starts clients phase-shifted on the SAME pose set so
    later clients hit frames cached by earlier ones; ``radius_spread`` > 0
    pushes client *pairs* outward (radius grows per pair, so each radius ring
    still has two phase-shifted clients whose poses overlap and hit the
    cache) to exercise coarser LOD levels. ``dup_pairs`` makes client 2k+1 an
    exact clone of client 2k (same orbit, same phase), so every request round
    submits each pose twice *in the same wavefront* — the duplicate-heavy
    trace that exercises the server's in-flight dedup (the cache cannot catch
    these: the first render has not landed when the twin submits).
    """
    clients = []
    for c in range(n_clients):
        # dup_pairs: both members of a pair take the pair's identity
        ident = c // 2 if dup_pairs else c
        radius = base_radius * (1.0 + radius_spread) ** (ident // 2)
        if shared_orbit or dup_pairs:
            phase = (ident * 3) % n_views
        else:
            # private trajectories: spread starting phases AND nudge each
            # radius past the pose quantum so no two clients ever share a
            # cache key (measures cache-free independent-viewer load)
            phase = (c * n_views) // max(n_clients, 1)
            radius *= 1.0 + 0.003 * (c + 1)
        clients.append(
            OrbitClient(
                c, n_views=n_views, img_h=img_h, img_w=img_w, radius=radius, phase=phase
            )
        )
    return clients


def run_load(
    server,
    clients: list[OrbitClient],
    *,
    requests_per_client: int,
    rate_hz: float = 0.0,
    flush_every_round: bool = True,
) -> dict:
    """Drive the server with interleaved client rounds; returns its report.

    Each round every client submits its next camera (one concurrent wavefront
    — what the micro-batcher coalesces), then the server drains. ``rate_hz``
    > 0 paces rounds in wall-clock time; 0 runs flat out.
    """
    period = 1.0 / rate_hz if rate_hz > 0 else 0.0
    for _ in range(requests_per_client):
        t0 = time.perf_counter()
        for cl in clients:
            server.submit(cl.next_camera(), client_id=cl.client_id)
        if flush_every_round:
            server.run()
        if period:
            left = period - (time.perf_counter() - t0)
            if left > 0:
                time.sleep(left)
    server.run()
    return server.report()
