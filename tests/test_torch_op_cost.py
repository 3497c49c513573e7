"""PyTorch port, the operation counter (``launch/op_cost.py`` ``OpCost``)
against the JAX package's HLO cost model on the programs of
``tests/test_hlo_cost.py``: a chain of 12 matmuls counts 2 x 128^3 x 12
flops exactly and lands within 2% of ``hlo_cost.analyze`` on the
``lax.scan`` form; a single matmul equals it. A gloo all-gather and
all-reduce on two ranks move ``hlo_stats``' ring bytes. The kernels'
regions report the shared formulas (``kernels/cost.py``) on the CPU and
only in the thread that counts, scatters charge the copy an out-of-place
one makes, and a small train step counts its projection, rasterizer
forward and backward."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hlo_stats
from repro.launch.hlo_cost import analyze
from repro_torch.kernels import cost as kcost
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.gsproject.ops import project_packed
from repro_torch.kernels.tile_raster import ops as tr_ops
from repro_torch.kernels.tile_raster.ref import composited_counts
from repro_torch.launch.op_cost import OpCost, ring_moved_bytes

from conftest import make_cam, make_scene
from torch_port_helpers import to_port

REPO = Path(__file__).resolve().parents[1]


def _hlo(f, *args) -> dict:
    return analyze(jax.jit(f).lower(*args).compile().as_text())


def test_chained_matmuls_count_exactly_and_match_hlo_cost_of_the_scan():
    a = jnp.ones((128, 128))

    def scanned(x):
        def body(c, _):
            return c @ a, None
        y, _ = jax.lax.scan(body, x, None, length=12)
        return y.sum()

    want = _hlo(scanned, jax.ShapeDtypeStruct((128, 128), jnp.float32))
    x, w = torch.ones(128, 128), torch.ones(128, 128)
    with OpCost() as chain:
        for _ in range(12):
            x = x @ w
    assert chain.result()["flops"] == 2 * 128**3 * 12
    with OpCost() as whole:
        y = torch.ones(128, 128)
        for _ in range(12):
            y = y @ w
        y.sum()
    got = whole.result()["flops"]
    assert abs(got - want["flops"]) / want["flops"] < 0.02, (got, want["flops"])


def test_single_matmul_flops_equal_hlo_cost():
    want = _hlo(lambda p, q: p @ q, jax.ShapeDtypeStruct((64, 32), jnp.float32),
                jax.ShapeDtypeStruct((32, 16), jnp.float32))
    with OpCost() as c:
        torch.ones(64, 32) @ torch.ones(32, 16)
    assert c.result()["flops"] == want["flops"] == 2 * 64 * 32 * 16


def test_bytes_views_inplace_and_meta():
    """Operands + result per op; a view costs nothing; an in-place op reads
    and writes its target; meta tensors count as real ones."""
    for dev in ("cpu", "meta"):
        x = torch.ones(64, 32, device=dev)
        with OpCost() as c:
            y = x.t()            # view: 0 bytes
            z = y + 1.0          # read 8 KiB, write 8 KiB
            z.mul_(2.0)          # read + write 8 KiB
        r = c.result()
        assert r["by_op"]["t"]["bytes"] == 0
        assert r["by_op"]["add"]["bytes"] == 2 * 64 * 32 * 4
        assert r["by_op"]["mul_"]["bytes"] == 2 * 64 * 32 * 4
        assert r["bytes"] == 4 * 64 * 32 * 4 and r["flops"] == 2 * 64 * 32
        assert r["peak_live_bytes"] == 64 * 32 * 4


def test_scatter_bytes_in_place_and_out_of_place():
    """An in-place scatter charges 3 x its update (``hlo_cost``'s rule); an
    out-of-place one also copies ``self`` whole: it reads it and writes the
    result."""
    idx = torch.arange(0, 1000, 10)
    upd = torch.ones(100, 11)
    for dev in ("cpu", "meta"):
        x = torch.zeros(1000, 11, device=dev)
        i, u = idx.to(dev), upd.to(dev)
        with OpCost() as c:
            y = x.index_put((i,), u, accumulate=True)
            x.index_put_((i,), u, accumulate=True)
        r = c.result()["by_op"]
        upd_b, self_b = 100 * 11 * 4, 1000 * 11 * 4
        assert r["index_put"]["bytes"] == 3 * upd_b + 2 * self_b
        assert r["index_put_"]["bytes"] == 3 * upd_b
        assert y.shape == x.shape


def test_a_region_on_another_thread_is_not_the_counters():
    """A counter counts the thread that entered it: a kernel launched on
    another thread meanwhile opens no region in it and adds nothing."""
    import threading

    g, cam = to_port(make_scene(50, 0), make_cam(16, 16))
    seen = {}

    def worker():
        seen["region"] = bool(kcost.region("gsproject"))
        seen["packed"] = project_packed(g, cam)

    with OpCost() as c:
        assert kcost.region("gsproject")
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["region"] is False and seen["packed"].shape == (g.n, 11)
    assert c.result()["by_op"] == {} and c._hidden == 0


def test_peak_live_bytes_follow_frees_and_count_the_backward():
    w = torch.randn(256, 256, requires_grad=True)
    with OpCost() as c:
        a = torch.randn(256, 256)        # 256 KiB, kept
        b = a @ w                        # 256 KiB, freed at once
        del b
        loss = (a @ w).square().sum()
        loss.backward()
    r = c.result()
    assert r["by_op"]["mm"]["count"] == 3  # forward, and the backward's dW (a needs no grad)
    assert r["flops"] >= 3 * 2 * 256**3
    assert 2 * 256 * 256 * 4 <= r["peak_live_bytes"] <= 6 * 256 * 256 * 4


_RANK_CODE = """
import sys, json, torch, torch.distributed as dist
from repro_torch.launch.op_cost import OpCost
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
x = torch.ones(1024) * (rank + 1)
g = torch.empty(2048)
with OpCost() as c:
    dist.all_reduce(x)
    dist.all_gather_into_tensor(g, torch.ones(1024))
r = c.result()
assert float(x[0]) == 3.0 and float(g.sum()) == 2048.0
json.dump(r["coll"], open(out + str(rank), "w"))
dist.destroy_process_group()
"""

_HLO = """HloModule m
ENTRY %main (p: f32[1024]) -> f32[2048] {
  %p = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %p), replica_groups={{0,1}}, to_apply=%add
  ROOT %ag = f32[2048]{0} all-gather(f32[1024]{0} %ar), replica_groups={{0,1}}, dimensions={0}
}
"""


def test_gloo_world_two_collectives_move_hlo_stats_ring_bytes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    store, out = str(tmp_path / "store"), str(tmp_path / "coll")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CODE, str(r), store, out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    want = hlo_stats.collective_stats(_HLO)
    for r in range(2):
        got = json.loads(Path(out + str(r)).read_text())
        for kind in ("all-reduce", "all-gather"):
            assert got[kind]["count"] == want[kind]["count"] == 1
            assert got[kind]["moved_bytes"] == want[kind]["moved_bytes"], (kind, got, want)
    assert ring_moved_bytes("reduce-scatter", 4096, 4) == 4096 * 3
    assert ring_moved_bytes("all-reduce", 4096, 1) == 0


def test_kernel_regions_on_the_cpu_report_the_shared_formulas():
    g, cam = to_port(make_scene(300, 0), make_cam(32, 32))
    with OpCost() as c:
        packed = project_packed(g, cam)
    r = c.result()
    assert r["by_op"]["gsproject"] == {"count": 1, "flops": float(g.n * 130), "bytes": float(g.n * 100)}
    assert set(r["by_op"]) == {"gsproject"}  # the plain version's ops are hidden

    rng = np.random.default_rng(3)
    t_count, k, th, tw = 8, 32, 16, 16
    splats = torch.tensor(rng.normal(0, 1, (t_count, 11, k)), dtype=torch.float32)
    splats[:, 0] = torch.tensor(rng.uniform(0, 64, (t_count, k)), dtype=torch.float32)
    splats[:, 1] = torch.tensor(rng.uniform(0, 32, (t_count, k)), dtype=torch.float32)
    splats[:, 2:5] = torch.tensor([0.05, 0.0, 0.05])[None, :, None]
    splats[:, 5] = torch.tensor(rng.uniform(0.1, 0.9, (t_count, k)), dtype=torch.float32)
    valid = torch.tensor(rng.uniform(size=(t_count, k)) < 0.8, dtype=torch.float32)
    kw = dict(tiles_x=4, tile_h=th, tile_w=tw)
    leaf = splats.clone().requires_grad_()
    with OpCost() as c:
        out, tfin = tr_ops.Composite.apply(leaf, valid, 4, th, tw, 0)
        (out.sum() + tfin.sum()).backward()
    r = c.result()["by_op"]
    comp = composited_counts(splats, valid, **kw)
    hits = int(composited_counts(splats, valid, **kw, live_only=True).sum())
    assert hits > 0
    assert r["tile_raster_fwd"]["flops"] == kcost.raster_evals(valid, comp) * kcost.RASTER_OPS_PER_EVAL
    assert r["tile_raster_fwd"]["bytes"] == kcost.raster_bytes(valid, th * tw)
    assert r["tile_raster_bwd"]["flops"] == hits * kcost.RASTER_BWD_OPS_PER_HIT
    assert r["tile_raster_bwd"]["bytes"] == kcost.raster_bwd_bytes(valid, th * tw)

    q, kk, v = (torch.randn(2, 40, 4, 32) for _ in range(3))
    with OpCost() as c:
        flash_attention(q, kk[:, :, :2].contiguous(), v[:, :, :2].contiguous(), causal=True, window=16)
    fl, nb = kcost.attention_cost(q, kk[:, :, :2], v[:, :, :2], causal=True, window=16)
    assert c.result()["by_op"]["flash_attention"] == {"count": 1, "flops": float(fl), "bytes": float(nb)}
    assert fl == 4 * 32 * kcost.attention_pairs(40, 40, True, 16, 0) * 2 * 4
    assert packed.shape == (g.n, 11)


def test_region_is_free_without_a_counter():
    assert not kcost._counters and not kcost.region("x")
    with kcost.region("x") as r:
        assert not r


def test_train_step_counts_every_kernel_and_the_plain_backward():
    from repro_torch.configs.gs_datasets import paper_scene
    from repro_torch.core import gaussians as G
    from repro_torch.core.config import GSConfig
    from repro_torch.core.train import init_state, make_train_step
    from repro_torch.data.views import ViewDataset

    from repro_torch.volume import kingsnake_like

    host, _, vol = paper_scene("kingsnake", 2000, 0, vol=kingsnake_like(res=32))
    cfg = GSConfig(img_h=32, img_w=32, batch_size=2, k_per_tile=64)
    state = init_state(G.from_numpy(host, "cpu"))
    data = ViewDataset(vol, n_views=2, img_h=32, img_w=32, radius=3.0, device="cpu")
    cams, gt = next(iter(data.batches(2, steps=1)))
    step = make_train_step(cfg)
    with OpCost() as c:
        state, m = step(state, cams, gt)
    r = c.result()
    assert r["by_op"]["gsproject"]["count"] == 2
    assert r["by_op"]["tile_raster_fwd"]["count"] == 2 and r["by_op"]["tile_raster_bwd"]["count"] == 2
    assert r["by_op"]["convolution"]["flops"] > 0 and r["by_op"]["convolution_backward"]["flops"] > 0
    assert r["flops"] > 0 and r["bytes"] > 0 and r["peak_live_bytes"] > 0
    assert r["coll_total_moved_bytes"] == 0
    assert np.isfinite(float(m["loss"]))


def test_gsproject_cost_counts_the_sh_bands():
    """The projection's formula per SH degree: 12 more bytes a coefficient,
    and each band's operations (gsproject.cu eval_sh_color) once the model
    has it; the CPU's region reports the same for a model at each degree."""
    want = {1: (130, 100), 4: (165, 136), 9: (210, 196), 16: (280, 280)}
    for c, (ops, nbytes) in want.items():
        assert kcost.gsproject_cost(1, c) == (ops, nbytes)
        assert kcost.gsproject_cost(4_000_000, c) == (4_000_000 * ops, 4_000_000 * nbytes)
    assert [nbytes * 4_000_000 / 3.35e12 * 1e3 for _, nbytes in list(want.values())[1:]] == pytest.approx(
        [0.162, 0.234, 0.334], abs=1e-3)  # the byte bounds at 4M on an H100
    g, cam = to_port(make_scene(300, 0), make_cam(32, 32))
    for c, (ops, nbytes) in want.items():
        sh = torch.tensor(np.random.default_rng(c).normal(0, 0.3, (g.n, c, 3)), dtype=torch.float32)
        with OpCost() as counter:
            project_packed(g._replace(sh=sh), cam)
        assert counter.result()["by_op"] == {"gsproject": {"count": 1, "flops": float(g.n * ops),
                                                           "bytes": float(g.n * nbytes)}}
