"""PyTorch port, in situ slice: fixed-capacity init, dead-slot reseeding, the
temporal checkpoint store, the warm-start trainer, timeline serving and the
in situ CLI against the JAX package's ``insitu``, on the CPU (the port's
plain versions; the JAX side runs its ``backend="ref"`` default on a (1, 1)
``jax.make_mesh``). Both packages get the same numpy inputs.

Tolerances, each with its reason:
- reseeding is host numpy in both packages with the same generator draws:
  slots and counts bitwise, rows within atol 1e-7 (the seed rows' log scale
  is a float32 log taken by each package's own library);
- temporal-store sequences: bitwise both ways (the same numpy encoding);
- the trainer: ``loss_final`` rtol 1e-3 and PSNR 1e-3 dB over 3 timesteps of
  4 cold and 3 warm steps (the multi-step tolerance of
  ``tests/test_torch_train.py``); ``changed_slots`` may differ in at most 1%
  of the capacity, because a row whose gradient is 0 in one package and
  1e-30 in the other still moves under Adam's eps 1e-15;
- served frames: atol 3e-6 / rtol 1e-5 (the rasterizer's forward tolerance).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gaussians as JG
from repro.core.config import GSConfig as JGSConfig
from repro.core.train import init_state as jax_init_state
from repro.insitu import InsituTrainer as JInsituTrainer
from repro.insitu import TemporalCheckpointStore as JStore
from repro.insitu import build_timeline_server as jax_build_timeline_server
from repro.insitu import fixed_capacity_init as jax_fixed_capacity_init
from repro.insitu import replay_live as jax_replay_live
from repro.insitu import reseed_dead_slots as jax_reseed
from repro.insitu import scrub as jax_scrub
from repro.volume.timevary import synthetic_stream as jax_stream
from repro_torch.core import gaussians as TG
from repro_torch.core.config import GSConfig
from repro_torch.core.projection import camera_from_numpy
from repro_torch.core.train import init_state, state_from_numpy, state_to_numpy
from repro_torch.insitu import (
    InsituTrainer,
    TemporalCheckpointStore,
    build_timeline_server,
    fixed_capacity_init,
    replay_live,
    reseed_dead_slots,
    scrub,
)
from repro_torch.launch import insitu as insitu_cli
from repro_torch.volume.timevary import synthetic_stream

from conftest import make_cam
from torch_port_helpers import np_

H = W = 32


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _random_params(n, seed=0, shift=0.0):
    """The JAX insitu tests' random model, as host numpy."""
    r = np.random.default_rng(seed)
    g = JG.init_from_points(
        jnp.asarray(r.normal(0, 0.4, (n, 3)).astype(np.float32) + shift),
        jnp.asarray(r.uniform(0.2, 0.8, (n, 3)).astype(np.float32)),
        init_scale=0.06,
    )
    return _np_tree(g)


# ---------------------------------------------------------------- capacity


def test_fixed_capacity_init_matches_jax():
    r = np.random.default_rng(0)
    pts = r.normal(0, 0.4, (300, 3)).astype(np.float32)
    cols = r.uniform(0.1, 0.9, (300, 3)).astype(np.float32)
    want = _np_tree(jax_fixed_capacity_init(pts, cols, 512, init_scale=0.06))
    got = fixed_capacity_init(pts, cols, 512, init_scale=0.06, device="cpu")
    assert got.means.device.type == "cpu"
    for name, a, b in zip(TG.GaussianModel._fields, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(np_(a), b, atol=1e-7, rtol=0, err_msg=name)
    opac = 1.0 / (1.0 + np.exp(-np_(got.opacity_logit)))
    assert (opac[:300] > 0.05).all() and (opac[300:] < 1e-6).all()
    assert (np_(got.means)[300:] == 1e6).all()


def _reseed_inputs():
    """A state at capacity 512 with 300 live rows, 40 of them pruned to
    transparency, nonzero Adam moments and densify statistics, and a fresh
    extraction of 150 points (fewer than the dead slots: a random subset of
    them is refilled)."""
    r = np.random.default_rng(1)
    pts = r.normal(0, 0.4, (300, 3)).astype(np.float32)
    g = jax_fixed_capacity_init(pts, np.full((300, 3), 0.5, np.float32), 512, init_scale=0.06)
    logit = np.asarray(g.opacity_logit).copy()
    logit[r.choice(300, 40, replace=False)] = -7.0
    g = g._replace(opacity_logit=jnp.asarray(logit))
    st = jax_init_state(g)
    ones = jax.tree_util.tree_map(lambda x: jnp.asarray(r.uniform(0.5, 1.5, x.shape), jnp.float32), st.params)
    st = st._replace(adam=st.adam._replace(m=ones, v=ones, count=jnp.int32(7)), step=jnp.int32(7),
                     grad2d_accum=jnp.asarray(r.uniform(0, 1, 512), jnp.float32),
                     vis_count=jnp.asarray(r.integers(0, 5, 512), jnp.float32),
                     max_radii=jnp.asarray(r.uniform(0, 3, 512), jnp.float32))
    new_pts = (r.normal(0, 0.4, (150, 3)) + 2.0).astype(np.float32)
    new_cols = r.uniform(0.2, 0.8, (150, 3)).astype(np.float32)
    return st, new_pts, new_cols


def test_reseed_dead_slots_matches_jax_on_the_same_generator():
    st, pts, cols = _reseed_inputs()
    jst, jn, jslots = jax_reseed(st, pts, cols, init_scale=0.06, rng=np.random.default_rng(3))
    tst, tn, tslots = reseed_dead_slots(state_from_numpy(_np_tree(st), "cpu"), pts, cols, init_scale=0.06,
                                        rng=np.random.default_rng(3))
    assert tn == jn == 150  # 252 dead slots (212 padding + 40 pruned), 150 new points
    np.testing.assert_array_equal(tslots, jslots)
    assert tslots.dtype == np.int64 and (np.diff(tslots) > 0).all()
    got, want = state_to_numpy(tst), _np_tree(jst)
    assert int(got.step) == int(want.step) == 7 and int(got.adam.count) == int(want.adam.count) == 7
    for part in ("params", "adam.m", "adam.v"):
        for name in TG.GaussianModel._fields:
            a = getattr(got.params if part == "params" else getattr(got.adam, part[5:]), name)
            b = getattr(want.params if part == "params" else getattr(want.adam, part[5:]), name)
            np.testing.assert_allclose(a, b, atol=1e-7, rtol=0, err_msg=f"{part}.{name}")
    for name in ("grad2d_accum", "vis_count", "max_radii"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert (getattr(got, name)[tslots] == 0).all()
    assert (got.adam.m.means[tslots] == 0).all() and (got.adam.v.sh[tslots] == 0).all()
    untouched = np.setdiff1d(np.arange(512), tslots)
    np.testing.assert_array_equal(got.params.means[untouched], want.params.means[untouched])


def test_reseed_with_no_dead_slots_is_identity_in_both():
    g = _random_params(16)
    st = init_state(TG.from_numpy(g, "cpu"))
    new, n, slots = reseed_dead_slots(st, np.zeros((5, 3), np.float32), np.zeros((5, 3), np.float32))
    _, jn, jslots = jax_reseed(jax_init_state(jax.tree_util.tree_map(jnp.asarray, g)), np.zeros((5, 3), np.float32),
                               np.zeros((5, 3), np.float32))
    assert n == jn == 0 and slots.size == jslots.size == 0
    assert new is st


# ----------------------------------------------------------- temporal store


def _sequence():
    """A key, two smooth deltas and a reseed jump (padding rows leaving the
    1e6 sentinel), as host numpy models."""
    rng = np.random.default_rng(2)
    g = _random_params(64, seed=3)
    g = g._replace(means=g.means.copy())
    g.means[48:] = 1.0e6
    frames = []
    for t in range(4):
        g = g._replace(means=g.means + rng.normal(0, 0.01, (64, 3)).astype(np.float32),
                       sh=g.sh + rng.normal(0, 0.02, g.sh.shape).astype(np.float32))
        if t == 3:
            means = g.means.copy()
            means[48:] = rng.normal(0, 0.4, (16, 3)).astype(np.float32)
            g = g._replace(means=means)
        frames.append(g)
    return frames


def _leaves(model):
    return [np.asarray(getattr(model, f)) for f in TG.GaussianModel._fields]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_temporal_store_sequences_cross_between_packages(tmp_path, writer):
    frames = _sequence()
    w_cls, r_cls = (TemporalCheckpointStore, JStore) if writer == "port" else (JStore, TemporalCheckpointStore)
    d = str(tmp_path / "seq")
    with w_cls(d, keyframe_interval=10) as store:
        for t, f in enumerate(frames):
            # the port's store takes device tensors (here CPU ones) as the trainer hands them over
            store.append(t, TG.from_numpy(f, "cpu") if writer == "port" else f)
        written = [_leaves(store.load(t)) for t in range(4)]
        slots = [store.changed_slots(t) for t in range(4)]
        stats = store.stats()
    assert stats["keyframes"] == 1 and stats["delta_frames"] == 3
    reader = r_cls(d)
    assert reader.timesteps() == [0, 1, 2, 3]
    for t in range(4):
        for a, b in zip(_leaves(reader.load(t)), written[t]):
            np.testing.assert_array_equal(a, b)
        got = reader.changed_slots(t)
        assert (got is None) == (slots[t] is None) == (t == 0)
        if t:
            np.testing.assert_array_equal(got, slots[t])
    np.testing.assert_array_equal(np.asarray(reader.load(3).means)[48:], frames[3].means[48:])  # jumps exact
    assert set(range(48, 64)) <= set(reader.changed_slots(3).tolist())


def test_temporal_store_files_equal_the_jax_stores(tmp_path):
    """The same appends through both stores leave the same arrays on disk."""
    frames = _sequence()
    for cls, name in ((TemporalCheckpointStore, "t"), (JStore, "j")):
        with cls(str(tmp_path / name), keyframe_interval=2, async_writes=False) as store:
            for t, f in enumerate(frames):
                store.append(t, f)
    assert json.load(open(tmp_path / "t" / "sequence.json")) == json.load(open(tmp_path / "j" / "sequence.json"))
    for t in (1, 3):
        with np.load(tmp_path / "t" / f"delta_{t:08d}.npz") as a, np.load(tmp_path / "j" / f"delta_{t:08d}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for t in (0, 2):
        for f in sorted(os.listdir(tmp_path / "j" / f"step_{t:08d}")):
            if f.endswith(".npy"):
                np.testing.assert_array_equal(np.load(tmp_path / "t" / f"step_{t:08d}" / f),
                                              np.load(tmp_path / "j" / f"step_{t:08d}" / f))


def test_temporal_store_copies_tensors_before_append_returns(tmp_path):
    g = TG.from_numpy(_random_params(24, seed=4), "cpu")
    d = str(tmp_path / "seq")
    store = TemporalCheckpointStore(d, keyframe_interval=3)
    store.append(0, g)
    before = np_(g.means).copy()
    g.means.add_(5.0)  # the caller changes its tensors while the writer may still encode
    store.append(1, g)
    g.means.add_(5.0)
    store.close()
    np.testing.assert_array_equal(np.asarray(store.load(0).means), before)
    np.testing.assert_allclose(np.asarray(store.load(1).means), before + 5.0, atol=1e-6)

    reopened = TemporalCheckpointStore(d, keyframe_interval=7)
    assert reopened.keyframe_interval == 3  # the on-disk sequence owns its cadence
    assert reopened.timesteps() == [0, 1]
    reopened.append(2, g)
    np.testing.assert_allclose(np.asarray(reopened.load(2).means), before + 10.0, atol=1e-6)
    assert reopened.stats()["keyframes"] == 1
    with pytest.raises(AssertionError):
        reopened.append(2, g)  # timesteps must be strictly increasing
    reopened.close()
    assert JStore(d).keyframe_interval == 3


# ----------------------------------------------------------------- trainer

CFG = dict(img_h=H, img_w=W, batch_size=2, k_per_tile=128, max_steps=10, densify_from=10**9,
           opacity_reset_interval=10**9)
TRAINER = dict(cold_steps=4, warm_steps=3, n_views=4, max_points=600, n_steps_raymarch=32, init_scale=0.06,
               seed=0)


def test_insitu_trainer_matches_jax_over_three_timesteps(capsys):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jt = JInsituTrainer(JGSConfig(**CFG), mesh, **TRAINER)
    want = jt.run(jax_stream("miranda", 3, res=24, t1=0.15))
    tt = InsituTrainer(GSConfig(**CFG), device="cpu", **TRAINER)
    got = tt.run(synthetic_stream("miranda", 3, res=24, t1=0.15))

    assert tt.capacity == jt.capacity == 1024
    assert [r.mode for r in got] == ["cold", "warm", "warm"]
    assert tt.n_traces == jt.n_traces == 1
    assert [r.n_traces for r in got] == [1, 1, 1]
    assert len(tt.step_losses) == len(tt.step_ms) == 4 + 3 + 3
    assert [s.size for s in tt.reseed_log] == [r.n_reseeded for r in got[1:]]
    for a, b in zip(got, want):
        assert (a.t_index, a.name, a.steps, a.n_extracted, a.n_reseeded) == \
            (b.t_index, b.name, b.steps, b.n_extracted, b.n_reseeded)
        np.testing.assert_allclose(a.loss_final, b.loss_final, rtol=1e-3)
        assert abs(a.psnr_before - b.psnr_before) <= 1e-3 and abs(a.psnr_after - b.psnr_after) <= 1e-3
        assert (a.changed_slots is None) == (b.changed_slots is None)
        if a.changed_slots is not None:
            diff = sorted(set(a.changed_slots) ^ set(b.changed_slots))
            print(f"t={a.t_index}: {len(a.changed_slots)} changed slots in the port, {len(b.changed_slots)} in the "
                  f"JAX package; rows in one set only: {diff}")
            assert len(diff) <= 0.01 * tt.capacity, diff
    assert got[1].n_reseeded > 0
    snap = tt.obs.metrics.snapshot()
    assert snap["train.timesteps"] == 3 and snap["train.reseeded"] == got[1].n_reseeded + got[2].n_reseeded
    assert snap["train.steps"] == 10 and snap["train.gather_bytes"] == 0


def test_insitu_trainer_feeds_a_live_server_and_resets_without_a_new_signature():
    """``run(server=...)``: the cold start re-registers the serving slot with
    a full drop, the warm timestep with its changed slots (a partial drop
    of the registered pose's rows); the served frame is then the trainer's
    model's. ``reset`` keeps the step: a cold start at the same capacity
    adds no shape signature."""
    from repro_torch.serve_gs import RenderServer

    cfg = GSConfig(**CFG)
    tt = InsituTrainer(cfg, device="cpu", **TRAINER)
    server = RenderServer(TG.from_numpy(_random_params(256, seed=8), "cpu"), cfg, device="cpu", n_levels=1,
                          max_batch=2)
    events = []
    server.add_invalidation_listener(lambda ts, rows: events.append(None if rows is None else len(rows)))
    cam = camera_from_numpy(make_cam(H, W))
    server.submit(cam).result()  # registers the pose the invalidator projects through
    vols = list(synthetic_stream("miranda", 2, res=24, t1=0.15))
    reports = tt.run(vols, server=server)
    assert reports[1].changed_slots and len(events) == 2 and events[0] is None and isinstance(events[1], int)
    fresh = RenderServer(tt.state.params, cfg, device="cpu", n_levels=1, max_batch=2)
    np.testing.assert_array_equal(server.submit(cam).result(), fresh.submit(cam).result())
    tt.reset()
    assert tt.state is None and tt.step_losses == [] and tt.reseed_log == []
    tt.start(vols[1])
    assert tt.n_traces == 1


def test_insitu_trainer_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InsituTrainer(GSConfig(**CFG))


# ---------------------------------------------------------- timeline serving


def _served_store(d):
    """One JAX-written sequence: three timesteps of a moving model, then two
    bounded 4-slot updates for the live replay."""
    with JStore(d, keyframe_interval=10) as store:
        g = _random_params(128, seed=5)
        store.append(0, g)
        for t in (1, 2):
            moved = g.means.copy()
            moved[:4] += np.float32(0.05 * t)
            store.append(t, g._replace(means=moved))


def test_timeline_server_scrub_and_replay_match_jax(tmp_path):
    d = str(tmp_path / "seq")
    _served_store(d)
    jcfg, tcfg = JGSConfig(img_h=H, img_w=W, k_per_tile=64), GSConfig(img_h=H, img_w=W, k_per_tile=64)
    cam = make_cam(H, W)
    kw = dict(n_levels=2, max_batch=2, cache_capacity=64)

    jserver = jax_build_timeline_server(JStore(d), jcfg, **kw)
    tserver = build_timeline_server(TemporalCheckpointStore(d), tcfg, device="cpu", **kw)
    assert tserver.timesteps() == jserver.timesteps() == [0, 1, 2]
    want = jax_scrub(jserver, cam, [0, 1, 2])
    got = scrub(tserver, camera_from_numpy(cam), [0, 1, 2])
    for t in (0, 1, 2):
        np.testing.assert_allclose(got[t], want[t], atol=3e-6, rtol=1e-5, err_msg=f"t={t}")
    assert np.abs(got[0] - got[2]).max() > 1e-4
    calls = tserver.report()["render"]["calls"]
    again = scrub(tserver, camera_from_numpy(cam), [0, 1, 2])
    assert tserver.report()["render"]["calls"] == calls  # the replay is all cache hits
    for t in (0, 1, 2):
        np.testing.assert_array_equal(again[t], got[t])

    events = {}
    frames = {}
    for name, build, replay, c, cfg in (("jax", jax_build_timeline_server, jax_replay_live, cam, jcfg),
                                        ("port", build_timeline_server, replay_live, camera_from_numpy(cam), tcfg)):
        extra = {} if name == "jax" else {"device": "cpu"}
        store = (JStore if name == "jax" else TemporalCheckpointStore)(d)
        srv = build(store, cfg, timesteps=[0], n_levels=1, max_batch=2, cache_capacity=64, **extra)
        ev = events[name] = []
        srv.add_invalidation_listener(lambda ts, rows, ev=ev: ev.append(None if rows is None else len(rows)))
        out = frames[name] = [srv.submit(c, timestep=0).result()]
        replay(store, srv, timesteps=[1, 2], serve_timestep=0,
               on_timestep=lambda t, srv=srv, c=c, out=out: out.append(srv.submit(c, timestep=0).result()))
    assert events["port"] == events["jax"] and len(events["port"]) == 2
    assert all(e is not None for e in events["port"])  # partial invalidations, never a full drop
    for a, b in zip(frames["port"], frames["jax"]):
        np.testing.assert_allclose(a, b, atol=3e-6, rtol=1e-5)


# --------------------------------------------------------------------- CLI


def test_insitu_cli_smoke_on_the_cpu(tmp_path, capsys):
    report = tmp_path / "report.json"
    insitu_cli.main(["--smoke", "--device", "cpu", "--timesteps", "2", "--cold-steps", "6", "--warm-steps", "3",
                     "--ckpt", str(tmp_path / "seq"), "--report", str(report),
                     "--metrics-out", str(tmp_path / "m.json")])
    out = json.loads(report.read_text())
    assert out["recompile_count"] == 1 and [t["mode"] for t in out["timesteps"]] == ["cold", "warm"]
    assert out["scrub"]["frames_distinct"] and out["scrub"]["replay_new_misses"] == 0
    assert out["scrub"]["replay_identical"] and out["live_replay"]["updates"] == 1
    assert out["store"]["timesteps"] == 2 and out["store"]["async_writes"]
    snap = json.loads((tmp_path / "m.json").read_text())
    assert snap["train.timesteps"] == 2 and snap["train.steps"] == 9
    assert "insitu ok" in capsys.readouterr().out
    assert JStore(str(tmp_path / "seq")).timesteps() == [0, 1]  # the JAX store reads the CLI's sequence


def test_insitu_cli_refuses_what_is_not_ported():
    with pytest.raises(SystemExit, match="torchrun"):  # one process per rank: no process group here
        insitu_cli.main(["--device", "cpu", "--model-par", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            insitu_cli.main(["--smoke"])
