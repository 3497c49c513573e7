"""PyTorch port, training across ranks: the sharded train step on spawned
gloo ranks against the JAX package's ``make_train_step`` on forced host
devices, and the training CLI under torchrun.

Both packages start from the same state (numpy, from a seed) on the same
batch: the reference test's scene (tests/test_distributed_gs.py:
kingsnake_like at res 32, 800 points, 32 px, batch 4, K 128), padded with
dead Gaussians to 1,024 so that it splits over 2 and 4 shards. The JAX
oracle runs every mesh in one subprocess with 4 forced host devices and
``backend="ref"``; the port runs one process per rank.

The JAX package's sharded gradients are data x model times the one-device
gradients (the transpose of its loss ``psum``; ``ROADMAP.md`` queue C), and
Adam (eps 1e-15) is blind to that scale. So the port's losses, parameters
and visibility statistics are held to the JAX sharded step, and its
gradients (Adam's first moment after one step is 0.1 * g) and
``grad2d_accum`` to the JAX one-device step. Tolerances are those of
``tests/test_torch_train.py``: gradients atol 2e-5 * max|g| and rtol 2e-4;
losses rtol 1e-5; parameters above the sign-flip floor atol 1e-6 and rtol
1e-5; four more steps from each package's own state rtol 1e-3.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro_torch.core import gaussians as TG
from repro_torch.core.render import resolve_binning
from repro_torch.core.train import init_state
from repro_torch.data.views import ViewDataset
from repro_torch.volume import datasets as TV
from repro_torch.volume.cameras import orbit_cameras
from repro_torch.volume.isosurface import extract_isosurface_points

REPO = Path(__file__).resolve().parents[1]
N_PAD = 1024
CFG = dict(img_h=32, img_w=32, tile_h=16, tile_w=16, k_per_tile=128, batch_size=4)
# 64 px in 4 px tiles: 256 tiles bin hierarchically ("auto"), a 32-row strip's 128 flat
HIER_CFG = dict(img_h=64, img_w=64, tile_h=4, tile_w=4, k_per_tile=32, batch_size=2)
STEPS = 5
MESHES = [((1, 2), "projected"), ((2, 1), "projected"), ((2, 2), "projected"), ((2, 2), "params3d")]


def _name(mesh, mode):
    return f"m{mesh[0]}x{mesh[1]}_{mode}"


ORACLE_RUNS = (
    [dict(name="one_device", mesh=[1, 1], cfg=CFG, inputs="a.")]
    + [dict(name=_name(m, g), mesh=list(m), cfg=dict(CFG, gather_mode=g), inputs="a.") for m, g in MESHES]
    + [dict(name="hier", mesh=[1, 2], cfg=HIER_CFG, inputs="h.")]
)

ORACLE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np, jax.numpy as jnp
    from repro.core import gaussians as G
    from repro.core.config import GSConfig
    from repro.core.projection import Camera
    from repro.core.train import GSTrainState, make_train_step, state_shardings
    from repro.optim.adam import AdamState

    d, steps = sys.argv[1], int(sys.argv[2])
    inp = dict(np.load(d + "/inputs.npz"))
    out = {}

    def flat(state, prefix):
        s = jax.tree_util.tree_map(np.asarray, state)
        o = {prefix + k: getattr(s, k) for k in ("step", "grad2d_accum", "vis_count", "max_radii")}
        o[prefix + "adam.count"] = s.adam.count
        for part, m in (("params", s.params), ("adam.m", s.adam.m), ("adam.v", s.adam.v)):
            o.update({f"{prefix}{part}.{f}": x for f, x in zip(m._fields, m)})
        return o

    for run in json.loads(open(d + "/oracle.json").read()):
        pre = run["inputs"]
        a = lambda k: jnp.asarray(inp[pre + "state." + k])
        model = lambda p: G.GaussianModel(*[a(p + "." + f) for f in G.GaussianModel._fields])
        st = GSTrainState(model("params"), AdamState(model("adam.m"), model("adam.v"), a("adam.count")),
                          a("step"), a("grad2d_accum"), a("vis_count"), a("max_radii"))
        dm, mm = run["mesh"]
        mesh = jax.make_mesh((dm, mm), ("data", "model"), devices=jax.devices()[: dm * mm])
        cams = Camera(*[jnp.asarray(inp[pre + "cams." + f]) for f in Camera._fields])
        gt = jnp.asarray(inp[pre + "gt"])
        step = make_train_step(mesh, GSConfig(**run["cfg"], backend="ref"))
        st = jax.device_put(st, state_shardings(mesh))
        losses = []
        for i in range(steps):
            st, m = step(st, cams, gt)
            losses.append(float(m["loss"]))
            if i == 0:
                out.update(flat(st, run["name"] + "/step1."))
        out[run["name"] + "/losses"] = np.asarray(losses)
    np.savez(d + "/oracle.npz", **out)
    """
)


def _scene_inputs(prefix: str, cfg: dict, n_views: int, seed: int) -> dict:
    """The reference test's scene as numpy: Kingsnake isosurface points
    (dead pads to N_PAD), random shapes and opacities so every field has a
    gradient, orbit cameras and their ray-marched views."""
    vol = TV.kingsnake_like(res=32)
    pts, _, cols = extract_isosurface_points(vol, max_points=800, seed=0)
    pad = N_PAD - pts.shape[0]
    pts = np.concatenate([pts, np.full((pad, 3), 1e6, np.float32)])
    cols = np.concatenate([cols, np.zeros((pad, 3), np.float32)])
    g = TG.init_from_points(pts, cols, init_scale=0.06, device="cpu")
    r = np.random.default_rng(seed)
    g = g._replace(
        log_scales=g.log_scales + torch.tensor(r.normal(0, 0.2, (N_PAD, 3)), dtype=torch.float32),
        quats=torch.tensor(r.normal(0, 1, (N_PAD, 4)), dtype=torch.float32),
        opacity_logit=torch.tensor(r.normal(0.0, 1.0, N_PAD), dtype=torch.float32),
    )
    out = TR.flat_state(init_state(g), prefix + "state.")
    h, w = cfg["img_h"], cfg["img_w"]
    data = ViewDataset(vol, n_views=n_views, img_h=h, img_w=w, n_steps_raymarch=48, device="cpu")
    cams = orbit_cameras(n_views, img_h=h, img_w=w)
    out.update({f"{prefix}cams.{f}": np.asarray(x) for f, x in zip(cams._fields, cams)})
    out[prefix + "gt"] = data.gt
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh of both packages, computed once: the JAX oracle in one
    subprocess while the port's ranks run (1 rank, then 2, then 4)."""
    tmp = tmp_path_factory.mktemp("ranks")
    inputs = {**_scene_inputs("a.", CFG, 4, 0), **_scene_inputs("h.", HIER_CFG, 2, 1)}
    (tmp / "jax").mkdir()
    np.savez(tmp / "jax" / "inputs.npz", **inputs)
    (tmp / "jax" / "oracle.json").write_text(json.dumps(ORACLE_RUNS))
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, str(tmp / "jax"), str(STEPS)], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH="src"), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    try:
        w1 = TR.spawn([dict(kind="train", name=f"w1_{g}", mesh=[1, 1], cfg=dict(CFG, gather_mode=g), inputs="a.",
                            steps=3, one_device=True) for g in ("projected", "params3d")], 1, inputs, tmp / "w1")
        tasks = {2: [], 4: []}
        for m, g in MESHES:
            tasks[m[0] * m[1]].append(dict(kind="train", name=_name(m, g), mesh=list(m), cfg=dict(CFG, gather_mode=g),
                                           inputs="a.", steps=STEPS))
        tasks[2].append(dict(kind="train", name="hier", mesh=[1, 2], cfg=HIER_CFG, inputs="h.", steps=STEPS))
        port = {w: TR.spawn(t, w, inputs, tmp / f"w{w}") for w, t in tasks.items()}
        log = oracle.communicate(timeout=TR.RANK_TIMEOUT_S)[0]
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.communicate()
    assert oracle.returncode == 0, log[-4000:]
    return {"jax": dict(np.load(tmp / "jax" / "oracle.npz")), "w1": w1[0], "port": port}


def _port_full(runs, name: str, mesh) -> dict:
    """The port's arrays for ``name``: the model shards of data rank 0 in
    order (per-Gaussian leaves concatenated), after checking that every data
    replica holds the same shard bitwise."""
    d, m = mesh
    ranks = runs["port"][d * m]
    out = {}
    for k in ranks[0]:
        if not k.startswith(name + "/") or k.endswith("/coords"):
            continue
        for i in range(1, d):
            for j in range(m):
                np.testing.assert_array_equal(ranks[i * m + j][k], ranks[j][k], err_msg=f"data replica {i}: {k}")
        key = k.split("/", 1)[1]
        per_gaussian = key.startswith(("step1.", "final.")) and not key.endswith(("step", "adam.count"))
        out[key] = np.concatenate([ranks[j][k] for j in range(m)]) if per_gaussian else ranks[0][k]
    return out


def assert_grad_close(got, want, err_msg=""):
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale + 1e-10, rtol=2e-4, err_msg=err_msg)


def _hold_to_jax(port: dict, jax_sharded: dict, jax_one: dict | None, label: str):
    np.testing.assert_allclose(port["losses"][0], jax_sharded["losses"][0], rtol=1e-5, err_msg=label)
    for f in TG.GaussianModel._fields:
        p_t, p_j = port[f"step1.params.{f}"], jax_sharded[f"step1.params.{f}"]
        g_ref = (jax_one or jax_sharded)[f"step1.adam.m.{f}"]
        above = np.abs(g_ref) > 1e-3 * np.abs(g_ref).max()
        assert above.any(), f
        np.testing.assert_allclose(p_t[above], p_j[above], atol=1e-6, rtol=1e-5, err_msg=f"{label} params.{f}")
        if jax_one is not None:
            g_t = port[f"step1.adam.m.{f}"] / 0.1
            assert np.isfinite(g_t).all(), f
            assert_grad_close(g_t, jax_one[f"step1.adam.m.{f}"] / 0.1, err_msg=f"{label} gradient of {f}")
    if jax_one is not None:
        assert_grad_close(port["step1.grad2d_accum"], jax_one["step1.grad2d_accum"], err_msg=f"{label} grad2d_accum")
    for k in ("vis_count", "max_radii"):
        np.testing.assert_array_equal(port[f"step1.{k}"], jax_sharded[f"step1.{k}"], err_msg=f"{label} {k}")
        if jax_one is not None:
            np.testing.assert_array_equal(port[f"step1.{k}"], jax_one[f"step1.{k}"], err_msg=f"{label} {k}")
    assert int(port["step1.step"]) == 1 and int(port["step1.adam.count"]) == 1
    # four more steps from each package's own state stay together
    np.testing.assert_allclose(port["losses"], jax_sharded["losses"], rtol=1e-3, err_msg=label)


def _jax(runs, name: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in runs["jax"].items() if k.startswith(name + "/")}


@pytest.mark.parametrize("mesh,mode", MESHES, ids=[_name(m, g) for m, g in MESHES])
def test_sharded_step_matches_jax(runs, mesh, mode):
    """Loss, parameters, vis_count and max_radii against the JAX sharded
    step; gradients and grad2d_accum against the JAX one-device step."""
    port = _port_full(runs, _name(mesh, mode), mesh)
    _hold_to_jax(port, _jax(runs, _name(mesh, mode)), _jax(runs, "one_device"), _name(mesh, mode))


@pytest.mark.parametrize("mesh", [m for m, g in MESHES if g == "projected"], ids=lambda m: f"m{m[0]}x{m[1]}")
def test_jax_sharded_gradient_is_data_times_model_the_ports(runs, mesh):
    """Pins the JAX package's fault (``ROADMAP.md`` queue C): in projected
    mode its sharded Adam moment and grad2d_accum are data x model times the
    port's, which equal the one-device step's."""
    dm = mesh[0] * mesh[1]
    port, jax_sharded = _port_full(runs, _name(mesh, "projected"), mesh), _jax(runs, _name(mesh, "projected"))
    for k in [f"adam.m.{f}" for f in TG.GaussianModel._fields] + ["grad2d_accum"]:
        want, got = jax_sharded[f"step1.{k}"], dm * port[f"step1.{k}"]
        above = np.abs(want) > 1e-3 * np.abs(want).max()
        ratio = float(np.median(want[above] / port[f"step1.{k}"][above]))
        msg = f"{k}: the JAX sharded step is {ratio:.6g} x the port's, want {dm} (ROADMAP.md queue C)"
        assert ratio == pytest.approx(dm, rel=1e-4), msg
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5 * float(np.abs(want).max()), err_msg=msg)


def test_strips_bin_flat_where_the_frame_bins_hier(runs):
    """At 64 px in 4 px tiles the frame's 256 tiles bin hierarchically and a
    (1, 2) strip's 128 flat, in both packages ("auto" resolves per rendered
    image): the port's sharded step is held to the JAX sharded step."""
    tiles = (HIER_CFG["img_h"] // HIER_CFG["tile_h"]) * (HIER_CFG["img_w"] // HIER_CFG["tile_w"])
    assert resolve_binning("auto", tiles) == "hier" and resolve_binning("auto", tiles // 2) == "flat"
    _hold_to_jax(_port_full(runs, "hier", (1, 2)), _jax(runs, "hier"), None, "hier frame, flat strips")


@pytest.mark.parametrize("mode", ["projected", "params3d"])
def test_world_one_mesh_is_bitwise_the_one_device_step(runs, mode):
    """A (1, 1) mesh over one gloo rank runs every collective of the step
    and gives the one-device step's losses, parameters, Adam moments and
    densify statistics bit for bit (the card's test does the same over
    NCCL)."""
    w1 = runs["w1"]
    keys = [k for k in w1 if k.startswith(f"w1_{mode}/") and "one_device" not in k and not k.endswith("/coords")]
    assert len(keys) > 20
    for k in keys:
        np.testing.assert_array_equal(w1[k], w1[k.replace("/", "/one_device.", 1)], err_msg=k)


def test_train_cli_across_two_ranks_checkpoint_serves_and_restores_in_jax(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu --model-par 2`` at the reference test's size writes one
    full checkpoint; the one-device port serves a frame from it and the JAX
    package restores it."""
    import jax

    from repro.checkpoint import restore_checkpoint as jax_restore
    from repro.core import gaussians as JG
    from repro.core.train import init_state as jax_init_state
    from repro_torch.checkpoint import latest_step
    from repro_torch.core.config import GSConfig
    from repro_torch.core.train import make_batched_eval_render
    from repro_torch.launch import serve_gs as serve_cli
    from repro_torch.serve_gs import stack_cameras
    from repro_torch.volume import cameras as TC

    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "repro_torch.launch.train", "--device", "cpu", "--model-par", "2", "--volume-res", "32",
           "--max-points", "800", "--res", "32", "--steps", "3", "--views", "4", "--batch", "4",
           "--k-per-tile", "128", "--ckpt", str(ckpt), "--metrics-out", str(tmp_path / "m.json")]
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=TR.RANK_TIMEOUT_S,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1"))
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    assert r.stdout.count("final-loss") == 1  # only rank 0 prints
    assert latest_step(str(ckpt)) == 3
    snap = json.load(open(tmp_path / "m.json"))
    assert snap["train.steps"] == 3 and np.isfinite(snap["train.loss"])
    n = 1024  # 800 points padded to 2 shards x 256
    assert snap["train.gather_bytes"] == 3 * n * (11 + 3) * 4  # batch 4 over one data rank: "auto" is params3d
    assert sum(snap[f"train.shard_capacity.s{i}"] for i in range(2)) == n

    params = serve_cli.load_params_from_ckpt(str(ckpt))
    assert params.means.shape == (n, 3)
    cam = TC.camera_slice(TC.orbit_cameras(4, img_h=32, img_w=32), 0)
    with torch.no_grad():
        frame = make_batched_eval_render(GSConfig(img_h=32, img_w=32, k_per_tile=128))(params, stack_cameras([cam]))[0]
    assert frame.shape == (32, 32, 3) and torch.isfinite(frame).all() and frame.max() > 0.05

    zeros = JG.GaussianModel(*[np.zeros(s, np.float32) for s in ((1, 3), (1, 3), (1, 4), (1,), (1, 1, 3))])
    back = jax_restore(str(ckpt), 3, jax.tree_util.tree_map(np.asarray, jax_init_state(zeros)))
    np.testing.assert_array_equal(np.asarray(back.params.means), params.means.numpy())
    assert int(back.step) == 3 and np.asarray(back.adam.m.sh).shape == (n, 1, 3)
