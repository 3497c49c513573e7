"""Densification / pruning / shard rebalancing (3D-GS adaptive control).

Runs on the host between train steps, in numpy, exactly as the JAX package's
``core/densify.py`` does (the Gaussian count changes, so it is an
out-of-graph phase there too): the state comes to the host, clone / split /
prune and the padding run on numpy arrays with the same
``np.random.Generator`` draws in the same order, and the new state goes back
to the device the old one was on. Given the same generator, both packages
make the same children and the same permutation.

The rebalance step is Grendel's dynamic Gaussian redistribution: after
clone / split / prune the global set is padded to ``n_shards *
pad_quantum`` with dead Gaussians and shuffled, so every model-axis shard
carries the same load. Across ranks every rank gathers the full state, runs
the same round with the same generator, and keeps its own row block.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import gaussians as G
from repro_torch.core.config import GSConfig
from repro_torch.core.sharding import Mesh
from repro_torch.core.train import GSTrainState, gather_state, init_state, state_to_numpy
from repro_torch.optim.adam import AdamState

DEAD_LOGIT = -20.0  # sigmoid(-20) ~ 2e-9 < 1/255: never rasterized, zero grads


class DensifyReport(NamedTuple):
    n_before: int
    n_cloned: int
    n_split: int
    n_pruned: int
    n_after: int          # live count
    n_padded: int         # allocated count after padding


def _select(m: G.GaussianModel, mask: np.ndarray) -> G.GaussianModel:
    return G.GaussianModel(*[a[mask] for a in m])


def _cat(*models: G.GaussianModel) -> G.GaussianModel:
    return G.GaussianModel(*[np.concatenate(xs, axis=0) for xs in zip(*models)])


def densify_and_rebalance(
    state: GSTrainState,
    cfg: GSConfig,
    *,
    n_shards: int = 1,
    scene_extent: float = 1.0,
    rng: np.random.Generator | None = None,
    mesh: Mesh | None = None,
) -> tuple[GSTrainState, DensifyReport]:
    """3D-GS adaptive density control + equal re-sharding.

    clone: high view-space grad, small world size (under-reconstruction)
    split: high view-space grad, large world size (over-reconstruction)
    prune: opacity below threshold

    With ``mesh``, ``state`` is this rank's shard and ``n_shards`` must be
    the model axis's size: the round runs on the gathered full state (a
    collective: every rank of the mesh calls it, with the same generator)
    and returns this rank's shard of the new state. The report counts the
    full state."""
    rng = rng or np.random.default_rng(0)
    device = state.params.means.device
    if mesh is not None:
        if n_shards != mesh.model.size:
            raise ValueError(f"n_shards {n_shards} != the mesh's model axis {mesh.model.size}")
        state = gather_state(state, mesh)
    h = state_to_numpy(state)
    p = h.params
    n0 = p.means.shape[0]

    opac = 1.0 / (1.0 + np.exp(-p.opacity_logit))
    live = opac > cfg.prune_opacity_thresh
    avg_grad = h.grad2d_accum / np.maximum(h.vis_count, 1.0)
    scales = np.exp(p.log_scales).max(axis=1)

    hot = (avg_grad > cfg.densify_grad_thresh) & live & (h.vis_count > 0)
    small = scales <= cfg.densify_scale_thresh * scene_extent
    clone_mask = hot & small
    split_mask = hot & ~small

    # ---- clone: duplicate as-is (both copies receive future gradients)
    clones = _select(p, clone_mask)

    # ---- split: two children sampled inside the parent, scales shrunk 1.6x
    parents = _select(p, split_mask)
    n_split = parents.means.shape[0]
    rot = G.quat_to_rotmat(torch.from_numpy(parents.quats)).numpy()
    children = []
    for _ in range(2):
        noise = rng.normal(0.0, 1.0, (n_split, 3)).astype(np.float32) * np.exp(parents.log_scales)
        offs = np.einsum("nij,nj->ni", rot, noise)
        children.append(
            G.GaussianModel(
                means=parents.means + offs,
                log_scales=parents.log_scales - np.log(1.6),
                quats=parents.quats,
                opacity_logit=parents.opacity_logit,
                sh=parents.sh,
            )
        )

    keep_mask = live & ~split_mask  # split parents are replaced by children
    new_params = _cat(_select(p, keep_mask), clones, children[0], children[1])
    # fresh optimizer moments for newly created gaussians (3D-GS convention)
    fresh = G.GaussianModel(*[np.zeros_like(a) for a in _cat(clones, children[0], children[1])])
    new_m = _cat(_select(h.adam.m, keep_mask), fresh)
    new_v = _cat(_select(h.adam.v, keep_mask), fresh)

    n_live = new_params.means.shape[0]
    n_pruned = int(np.sum(~live))

    # ---- pad to the shard quantum, shuffled for load uniformity
    quantum = n_shards * cfg.pad_quantum
    n_padded = int(np.ceil(n_live / quantum) * quantum)
    pad = n_padded - n_live
    perm = rng.permutation(n_live)

    def pad_field(a, fill=0.0):
        return np.concatenate([a[perm], np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)

    new_params = G.GaussianModel(
        means=pad_field(new_params.means, 1e6),
        log_scales=pad_field(new_params.log_scales, -10.0),
        quats=pad_field(new_params.quats, 0.0),
        opacity_logit=pad_field(new_params.opacity_logit, DEAD_LOGIT),
        sh=pad_field(new_params.sh),
    )
    # quats padding needs a valid rotation
    new_params.quats[n_live:, 0] = 1.0
    new_m = G.GaussianModel(*[pad_field(a) for a in new_m])
    new_v = G.GaussianModel(*[pad_field(a) for a in new_v])
    if mesh is not None:  # this rank's row block
        k, j = n_padded // n_shards, mesh.model.index
        new_params, new_m, new_v = (G.GaussianModel(*[a[j * k:(j + 1) * k] for a in t])
                                    for t in (new_params, new_m, new_v))

    new_state = init_state(G.from_numpy(new_params, device))
    new_state = new_state._replace(
        adam=AdamState(G.from_numpy(new_m, device), G.from_numpy(new_v, device),
                       torch.tensor(h.adam.count, dtype=torch.int32, device=device)),
        step=torch.tensor(h.step, dtype=torch.int32, device=device),
    )
    report = DensifyReport(
        n_before=n0,
        n_cloned=int(clone_mask.sum()),
        n_split=n_split,
        n_pruned=n_pruned,
        n_after=n_live,
        n_padded=n_padded,
    )
    return new_state, report


def reset_opacity(state: GSTrainState, *, ceiling: float = 0.01) -> GSTrainState:
    """Periodic opacity reset (3D-GS: clamps opacity low to kill floaters).

    Dead (padding) gaussians stay dead."""
    logit = state.params.opacity_logit
    ceil_logit = float(np.log(ceiling / (1 - ceiling)))
    new = torch.where(logit > ceil_logit, torch.full_like(logit, ceil_logit), logit)
    new = torch.where(logit <= DEAD_LOGIT + 1e-3, logit, new)
    return state._replace(params=state.params._replace(opacity_logit=new))
