"""PyTorch port, serving across ranks: ``RenderServer(mesh=...)`` on spawned
gloo ranks against the port's one-device server and the JAX package's
``RenderServer(mesh=...)`` on forced host devices; the serving benchmark's
mirror under torchrun.

Both packages serve the same requests over the same scene (numpy, from a
seed): 512 Gaussians from ``conftest.make_scene``, 32 px, K 64, 2 LOD
levels, max_batch 4; four near and two far orbit views (levels 0 and 1)
as batched misses, the same six again as cache hits, two after
``invalidate(rows={1})`` (partial hits: strips) and two after
``add_timestep(changed=...)``. The port's frames on every mesh are held
bitwise to its ``mesh=None`` server, and to the JAX server on the same mesh
within the North star's atol 3e-6 / rtol 1e-5. The JAX oracle runs every
mesh in one subprocess with 4 forced host devices while the port's ranks
run (worlds 1, 2 and 4 at once).
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

import torch_ranks as TR
from conftest import make_scene
from repro_torch.volume.cameras import orbit_cameras

REPO = Path(__file__).resolve().parents[1]
ATOL, RTOL = 3e-6, 1e-5
CFG = dict(img_h=32, img_w=32, k_per_tile=64)
SERVER = dict(n_levels=2, max_batch=4, pipeline_depth=2)
MESHES = [(1, 2), (2, 1), (2, 2)]
MAX_BATCHES = [1, 3, 5, 8]
ROUNDS = ("miss", "hit", "partial", "changed")


def _name(mesh) -> str:
    return f"m{mesh[0]}x{mesh[1]}"


ORACLE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.core import gaussians as G
    from repro.core.config import GSConfig
    from repro.core.projection import Camera
    from repro.serve_gs import RenderServer

    d = sys.argv[1]
    inp = dict(np.load(d + "/inputs.npz"))
    spec = json.loads(open(d + "/oracle.json").read())
    model = lambda p: G.GaussianModel(*[inp[p + f] for f in G.GaussianModel._fields])
    cams = [Camera(*[inp["s.cams." + f][i] for f in Camera._fields]) for i in range(len(inp["s.cams.fx"]))]
    cfg = GSConfig(**spec["cfg"])
    out = {}
    for dm, mm in spec["meshes"]:
        mesh = jax.make_mesh((dm, mm), ("data", "model"), devices=jax.devices()[: dm * mm])
        name = f"m{dm}x{mm}"
        for mb in spec["max_batches"]:
            out[f"{name}/buckets.{mb}"] = np.asarray(
                RenderServer(model("s.params."), cfg, mesh=mesh, **dict(spec["server"], max_batch=mb)).batcher.buckets)
        srv = RenderServer(model("s.params."), cfg, mesh=mesh, **spec["server"])

        def serve(rnd, group):
            futs = [srv.submit(c) for c in group]
            srv.run()
            out[f"{name}/frames.{rnd}"] = np.stack([np.asarray(f.result()) for f in futs])

        serve("miss", cams)
        serve("hit", cams)
        srv.invalidate(0, rows={1})
        serve("partial", [cams[0], cams[-1]])
        srv.add_timestep(0, model("s.new."), changed=inp["s.changed"])
        serve("changed", cams[:2])
        rep = srv.report()
        out[f"{name}/counts"] = np.asarray([
            rep["completed"], rep["tiles"]["full_hits"], rep["tiles"]["partial_hits"], rep["tiles"]["frame_misses"],
            rep["tiles"]["rows_rendered_partial"], rep["render"]["calls"], *rep["lod"]["requests_per_level"]])
        out[f"{name}/buckets"] = np.asarray(srv.batcher.buckets)
        srv.close()
    np.savez(d + "/oracle.npz", **out)
    """
)


def _inputs(n: int = 512) -> dict:
    """The scene, its update (the two top Gaussians nudged), a 510-row
    model that splits into 2 shards and not into 4, and the cameras."""
    g = jax.tree_util.tree_map(np.array, make_scene(n=n, scale=0.06, seed=12))
    means = g.means.copy()
    changed = np.argsort(-means[:, 1])[:2]
    means[changed, 0] += 0.01
    out = {"s.changed": changed}
    for f in g._fields:
        out[f"s.params.{f}"] = getattr(g, f)
        out[f"s.new.{f}"] = means if f == "means" else getattr(g, f)
        out[f"r.params.{f}"] = getattr(g, f)[:510]
    near = orbit_cameras(4, img_h=CFG["img_h"], img_w=CFG["img_w"], radius=3.0)
    far = orbit_cameras(2, img_h=CFG["img_h"], img_w=CFG["img_w"], radius=12.0)  # level 1
    for f in near._fields:
        out[f"s.cams.{f}"] = np.concatenate([np.asarray(getattr(near, f)), np.asarray(getattr(far, f))])
    return out


def _serve_task(mesh, **kw) -> dict:
    return dict(kind="serve", name=_name(mesh), mesh=list(mesh), cfg=CFG, server=SERVER, inputs="s.",
                max_batches=MAX_BATCHES, **kw)


def _abort_task(inside_with: bool) -> dict:
    return dict(kind="serve_abort", name="abort", mesh=[1, 2], cfg=CFG, server=SERVER, inputs="s.",
                inside_with=inside_with)


# the CPU run checks completion and keys; on a shared CPU the traced lap's
# fps against the untraced laps is noise, so its budget is set out of reach
BENCH = ["benchmarks/serve_throughput_torch.py", "--smoke", "--device", "cpu", "--max-trace-overhead", "1.0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh of both packages, computed once: the port's worlds 1, 2
    and 4, two failing leads and the benchmark mirror on 2 ranks at once,
    the JAX oracle meanwhile."""
    tmp = tmp_path_factory.mktemp("serve_ranks")
    bench = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", *BENCH,
         "--out", str(tmp / "bench.json")], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1"))
    inputs = _inputs()
    (tmp / "jax").mkdir()
    np.savez(tmp / "jax" / "inputs.npz", **inputs)
    (tmp / "jax" / "oracle.json").write_text(json.dumps(
        dict(cfg=CFG, server=SERVER, meshes=[[1, 1]] + [list(m) for m in MESHES], max_batches=MAX_BATCHES)))
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, str(tmp / "jax")], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH="src"), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    try:
        started = {
            1: TR.start([_serve_task((1, 1), one_device=True)], 1, inputs, tmp / "w1"),
            2: TR.start([_serve_task((1, 2)), _serve_task((2, 1))], 2, inputs, tmp / "w2"),
            4: TR.start([_serve_task((2, 2)),
                         dict(kind="serve_refuses", name="refuses", mesh=[1, 4], cfg=CFG, server=SERVER,
                              inputs="r.")], 4, inputs, tmp / "w4"),
            "abort_with": TR.start([_abort_task(True)], 2, inputs, tmp / "abort_with"),
            "abort_dies": TR.start([_abort_task(False)], 2, inputs, tmp / "abort_dies"),
        }
        port = {w: TR.finish(started[w]) for w in (1, 2, 4)}
        aborts = {k: TR.finish(started[k], check=False) for k in ("abort_with", "abort_dies")}
        log = oracle.communicate(timeout=TR.RANK_TIMEOUT_S)[0]
        bench_log = bench.communicate(timeout=TR.RANK_TIMEOUT_S)[0]
    finally:
        for p in (oracle, bench):
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert oracle.returncode == 0, log[-4000:]
    return {"jax": dict(np.load(tmp / "jax" / "oracle.npz")), "port": port, "aborts": aborts,
            "bench": (bench.returncode, bench_log, tmp / "bench.json")}


def _lead(runs, mesh) -> dict:
    """The lead's outputs for ``mesh``; every follower says it followed."""
    ranks = runs["port"][mesh[0] * mesh[1]]
    name = _name(mesh)
    for r in ranks[1:]:
        assert int(r[f"{name}/followed"]) == 1
    return {k.split("/", 1)[1]: v for k, v in ranks[0].items() if k.startswith(name + "/")}


def _one_device(runs) -> dict:
    w1 = _lead(runs, (1, 1))
    return {k[len("one_device."):]: v for k, v in w1.items() if k.startswith("one_device.")}


def _jax(runs, mesh) -> dict:
    name = _name(mesh)
    return {k.split("/", 1)[1]: v for k, v in runs["jax"].items() if k.startswith(name + "/")}


def test_world_one_gloo_mesh_is_bitwise_the_one_device_server(runs):
    """A (1, 1) mesh over one gloo rank sends every descriptor and runs
    every collective of serving, and serves the one-device server's frames
    bit for bit, with the same counts."""
    got, want = _lead(runs, (1, 1)), _one_device(runs)
    for rnd in ROUNDS:
        np.testing.assert_array_equal(got[f"frames.{rnd}"], want[f"frames.{rnd}"], err_msg=rnd)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    mesh_rep = json.loads(str(got["mesh_report"]))
    assert mesh_rep["data"] == mesh_rep["model"] == 1 and mesh_rep["control_sends"] >= 5


@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_mesh_server_is_bitwise_the_one_device_server(runs, mesh):
    """Batched misses, cache hits, partial-hit strips and the rows dirtied
    by ``add_timestep(changed=...)`` on a (data, model) mesh equal the
    port's one-device frames bitwise: projection is per Gaussian and the
    model gather puts the rows back in order."""
    got, want = _lead(runs, mesh), _one_device(runs)
    for rnd in ROUNDS:
        np.testing.assert_array_equal(got[f"frames.{rnd}"], want[f"frames.{rnd}"], err_msg=f"{_name(mesh)} {rnd}")
    np.testing.assert_array_equal(got["counts"][:5], want["counts"][:5])  # completed, hits, partials, misses, rows
    np.testing.assert_array_equal(got["counts"][6:], want["counts"][6:])  # requests per level
    c = got["counts"]
    assert c[0] == 16 and c[1] >= 6 and c[2] >= 2 and c[4] >= 2 and c[6] > 0 and c[7] > 0, c


@pytest.mark.parametrize("mesh", [(1, 1)] + MESHES, ids=_name)
def test_mesh_server_matches_jax_server_on_the_same_mesh(runs, mesh):
    """The JAX server on the same forced-device mesh serves the same frames
    within atol 3e-6 / rtol 1e-5 (its strips bin flat; the port's keep the
    frame's geometry, which at 32 px is flat too) and the same counts."""
    got, want = _lead(runs, mesh), _jax(runs, mesh)
    for rnd in ROUNDS:
        assert got[f"frames.{rnd}"].shape == want[f"frames.{rnd}"].shape
        np.testing.assert_allclose(got[f"frames.{rnd}"], want[f"frames.{rnd}"], atol=ATOL, rtol=RTOL,
                                   err_msg=f"{_name(mesh)} {rnd}")
    np.testing.assert_array_equal(got["counts"], want["counts"])


@pytest.mark.parametrize("mesh", [(1, 1)] + MESHES, ids=_name)
def test_buckets_equal_the_jax_servers(runs, mesh):
    """``max_batch`` rounds up to a multiple of the data axis and the
    default buckets are d x default_buckets(max_batch // d), as in the JAX
    server, for every max_batch tried."""
    got, want = _lead(runs, mesh), _jax(runs, mesh)
    np.testing.assert_array_equal(got["buckets"], want["buckets"])
    for mb in MAX_BATCHES:
        np.testing.assert_array_equal(got[f"buckets.{mb}"], want[f"buckets.{mb}"], err_msg=f"max_batch {mb}")
        assert all(b % mesh[0] == 0 for b in got[f"buckets.{mb}"])


def test_rows_that_do_not_split_over_the_model_axis_raise_on_every_rank(runs):
    """510 Gaussians on a (1, 4) mesh: level 0 is the model verbatim and
    does not split into 4 shards, so every rank's constructor raises a
    ValueError naming n and m (nothing is padded silently)."""
    for r in runs["port"][4]:
        msg = str(r["refuses/error"])
        assert "n=510" in msg and "m=4" in msg, msg


@pytest.mark.parametrize("case", ["abort_with", "abort_dies"])
def test_followers_exit_nonzero_when_the_lead_fails(runs, case):
    """A lead that raises mid-serve, inside ``with`` (the abort op) or
    outside it (its process dies with the control group), makes its
    follower raise and exit non-zero within seconds, far inside the control
    group's timeout, instead of waiting for it."""
    from repro_torch.serve_gs.server import CONTROL_TIMEOUT_S

    codes, logs = runs["aborts"][case]
    assert codes[0] != 0 and "the lead fails mid-serve" in logs[0], logs[0][-2000:]
    assert codes[1] != 0, logs[1][-2000:]
    want = "aborted serving" if case == "abort_with" else "Connection closed"
    assert want in logs[1], logs[1][-2000:]
    served = float(re.search(r"follower served for ([0-9.]+) s", logs[1]).group(1))
    assert served < 30.0 < CONTROL_TIMEOUT_S, served


def test_serve_throughput_mirror_on_two_gloo_ranks(runs):
    """``benchmarks/serve_throughput_torch.py --smoke --device cpu`` under
    torchrun on 2 gloo ranks completes every request of every scenario (it
    exits non-zero otherwise) and reports the JAX benchmark's keys."""
    code, log, out = runs["bench"]
    assert code == 0, log[-4000:]
    rep = json.loads(out.read_text())
    for key in ("scene", "devices", "request_set", "serial", "batched", "batched_speedup", "cached", "sync",
                "pipelined", "pipeline_speedup", "deduped", "tracing", "lod"):
        assert key in rep, key
    assert rep["devices"] == 2 and rep["mesh"] == [2, 1]
    assert rep["batched"]["mean_batch"] >= 2 and rep["deduped"] > 0
    assert len(rep["lod"]["batch_render_ms"]) == len(rep["lod"]["live_counts"]) and all(
        ms > 0 for ms in rep["lod"]["batch_render_ms"])
    assert rep["tracing"]["spans"] > 0 and rep["tracing"]["dropped"] == 0
