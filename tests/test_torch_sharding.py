"""PyTorch port, the distribution primitives against the JAX package: the
packed gradient vector, the gather-mode and all-gather-bytes model, the
strip halo exchange and the loss across 2 and 4 pixel strips, shard
balance over 4 shards, densification with re-sharding over 2 and 4 shards,
and the sharded checkpoint of its result. Ranks are spawned gloo processes (``tests/torch_ranks.py``); the
JAX package's ``shard_balance`` runs on 4 forced host devices in a
subprocess.

Tolerances: the loss sums rtol 1e-5 (float32 sums in another order); the
gradient with respect to each strip atol 2e-5 * max|g| and rtol 2e-4 (the
JAX package's kernel test tolerance); densification atol 1e-6 (rotation
matrices a few ulp apart, as in ``tests/test_torch_train.py``).
"""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro.core import gaussians as JG
from repro.core import sharding as JS
from repro.core.config import GSConfig as JGSConfig
from repro.core.densify import densify_and_rebalance as jax_densify
from repro.core.train import GSTrainState as JState
from repro.core.train import all_gather_bytes_per_step as jax_bytes
from repro.core.train import resolve_gather_mode as jax_mode
from repro.optim.adam import AdamState as JAdamState
from repro.utils import tree as JT
from repro_torch.core import gaussians as TG
from repro_torch.core.config import GSConfig
from repro_torch.core.train import all_gather_bytes_per_step, init_state, resolve_gather_mode
from repro_torch.launch.mesh import make_gs_mesh
from repro_torch.utils import tree as TT

from torch_port_helpers import np_

REPO = Path(__file__).resolve().parents[1]
N = 512
DENSIFY_CFG = dict(img_h=32, img_w=32, tile_h=16, tile_w=16, k_per_tile=128, batch_size=2, pad_quantum=64)


def _model(seed: int = 0, n: int = N) -> dict:
    r = np.random.default_rng(seed)
    return {
        "means": r.normal(0, 0.3, (n, 3)).astype(np.float32),
        "log_scales": r.uniform(-6, -2, (n, 3)).astype(np.float32),
        "quats": r.normal(0, 1, (n, 4)).astype(np.float32),
        "opacity_logit": r.uniform(-8, 3, n).astype(np.float32),
        "sh": r.uniform(0, 1, (n, 1, 3)).astype(np.float32),
    }


def _state_arrays(seed: int) -> dict:
    """A train state as numpy, with densify statistics and Adam moments
    that are not zero (step 9)."""
    r = np.random.default_rng(seed + 100)
    p = _model(seed)
    out = {f"params.{k}": v for k, v in p.items()}
    out.update({f"adam.m.{k}": (v * 0 + 0.5).astype(np.float32) for k, v in p.items()})
    out.update({f"adam.v.{k}": (v * 0 + 0.25).astype(np.float32) for k, v in p.items()})
    out.update({"adam.count": np.int32(9), "step": np.int32(9),
                "grad2d_accum": r.uniform(0, 6e-4, N).astype(np.float32),
                "vis_count": r.integers(0, 3, N).astype(np.float32),
                "max_radii": r.uniform(-1, 3, N).astype(np.float32)})
    return out


def _jax_state(arrays: dict) -> JState:
    def model(prefix):
        return JG.GaussianModel(*[jnp.asarray(arrays[f"{prefix}.{f}"]) for f in JG.GaussianModel._fields])

    return JState(model("params"), JAdamState(model("adam.m"), model("adam.v"), jnp.asarray(arrays["adam.count"])),
                  jnp.asarray(arrays["step"]), jnp.asarray(arrays["grad2d_accum"]),
                  jnp.asarray(arrays["vis_count"]), jnp.asarray(arrays["max_radii"]))


def _loss_inputs(seed: int = 3) -> dict:
    r = np.random.default_rng(seed)
    pred = r.uniform(0, 1, (2, 32, 24, 3)).astype(np.float32)
    gt = np.clip(pred + r.normal(0, 0.2, pred.shape), 0, 1).astype(np.float32)
    return {"l.pred": pred, "l.gt": gt}


# 4 shards with the first one dead, built in numpy (the reference test's
# eager .at[].set on a sharded array raises on jax 0.9; ROADMAP.md queue C)
BALANCE_ORACLE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np, jax.numpy as jnp
    from repro.core import gaussians as G
    from repro.core.train import GSTrainState, shard_balance, state_shardings, record_shard_balance
    from repro.obs import MetricsRegistry
    from repro.optim.adam import AdamState

    inp = dict(np.load(sys.argv[1]))
    a = lambda k: jnp.asarray(inp["b.state." + k])
    model = lambda p: G.GaussianModel(*[a(p + "." + f) for f in G.GaussianModel._fields])
    st = GSTrainState(model("params"), AdamState(model("adam.m"), model("adam.v"), a("adam.count")),
                      a("step"), a("grad2d_accum"), a("vis_count"), a("max_radii"))
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    bal = shard_balance(jax.device_put(st, state_shardings(mesh)))
    reg = MetricsRegistry()
    record_shard_balance(reg, bal)
    print(json.dumps({"balance": bal, "snapshot": reg.snapshot()}))
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The loss over 2 and 4 strips, shard balance over 4 shards and the
    densify round over 2 and 4 shards, on 2 and 4 gloo ranks; the JAX
    package's shard balance in a subprocess meanwhile."""
    tmp = tmp_path_factory.mktemp("sharding")
    bal = _state_arrays(1)
    bal["params.opacity_logit"][: N // 4] = -20.0  # shard 0 dead
    inputs = {**_loss_inputs(), **{f"d.state.{k}": v for k, v in _state_arrays(4).items()},
              **{f"b.state.{k}": v for k, v in bal.items()}}
    np.savez(tmp / "oracle_inputs.npz", **inputs)
    oracle = subprocess.Popen([sys.executable, "-c", BALANCE_ORACLE, str(tmp / "oracle_inputs.npz")], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH="src"), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for m in (2, 4):
            tasks = [dict(kind="loss", name="loss", mesh=[1, m], inputs="l."),
                     dict(kind="densify", name="densify", mesh=[1, m], inputs="d.", cfg=DENSIFY_CFG, seed=11,
                          ckpt=str(tmp / f"ckpt{m}"))]
            if m == 4:
                tasks.append(dict(kind="balance", name="balance", mesh=[1, 4], inputs="b."))
            port[m] = TR.spawn(tasks, m, inputs, tmp / f"w{m}")
        out, err = oracle.communicate(timeout=TR.RANK_TIMEOUT_S)
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.communicate()
    assert oracle.returncode == 0, err[-4000:]
    return {"port": port, "jax_balance": json.loads(out.strip().splitlines()[-1]), "inputs": inputs, "tmp": tmp}


# ---------------------------------------------------------------- tree


def test_pack_and_unpack_pytree_match_jax():
    arrays = _model(5, n=7)
    tree = {"b": TG.GaussianModel(*[torch.tensor(arrays[f]) for f in TG.GaussianModel._fields]),
            "a": (torch.arange(3, dtype=torch.int32), torch.ones(2, 2, dtype=torch.float64))}
    jtree = {"b": JG.GaussianModel(*[jnp.asarray(arrays[f]) for f in JG.GaussianModel._fields]),
             "a": (jnp.arange(3, dtype=jnp.int32), jnp.ones((2, 2), jnp.float32))}
    vec, unpack = TT.pack_pytree(tree)
    jvec, _ = JT.pack_pytree(jtree)
    assert vec.dtype == torch.float32
    np.testing.assert_array_equal(np_(vec), np.asarray(jvec))
    back = TT.unpack_pytree(vec * 2, tree)
    assert type(back["b"]) is TG.GaussianModel and back["a"][0].dtype == torch.int32
    assert back["a"][1].dtype == torch.float64
    for got, x in zip(TT.tree_leaves(back), TT.tree_leaves(tree)):
        assert got.shape == x.shape
        np.testing.assert_array_equal(np_(got), np_(x * 2).astype(np_(got).dtype))
    assert TT.tree_count(tree) == JT.tree_count(jtree) == 7 * 14 + 3 + 4
    assert TT.tree_bytes(tree) == 7 * 14 * 4 + 3 * 4 + 4 * 8
    assert TT.pack_pytree(())[0].shape == (0,)


# ---------------------------------------------------------------- gather mode and bytes


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (1, 4), (4, 1)], ids=lambda s: f"m{s[0]}x{s[1]}")
def test_gather_mode_and_bytes_match_jax(shape):
    """Both packages read only the mesh's ``shape``, so a namespace stands
    in for the mesh: batch 1 and 4, every gather mode."""
    mesh = types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
    for batch in (1, 4):
        for mode in ("auto", "projected", "params3d"):
            kw = dict(batch_size=batch, gather_mode=mode)
            cfg, jcfg = GSConfig(**kw), JGSConfig(**kw)
            assert resolve_gather_mode(cfg, mesh) == jax_mode(jcfg, mesh), (batch, mode)
            for n in (1024, 4_000_000):
                assert all_gather_bytes_per_step(cfg, mesh, n) == jax_bytes(jcfg, mesh, n), (batch, mode, n)
    one = GSConfig(batch_size=4, gather_mode="params3d")
    assert resolve_gather_mode(one, None) == "params3d" and all_gather_bytes_per_step(one, None, 1024) == 0


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_gs_mesh(1, 2, device="cpu")


# ---------------------------------------------------------------- halo exchange and loss


@pytest.mark.parametrize("m", [2, 4])
def test_loss_across_strips_matches_the_one_image_loss(runs, m):
    """Each strip's (ssim, l1, count), summed over the strips, equals the
    JAX one-image ``ssim_l1_sums``; the loss equals the one-device loss on
    every rank, and each strip's gradient equals the rows of the one-device
    gradient."""
    pred, gt = runs["inputs"]["l.pred"], runs["inputs"]["l.gt"]
    ranks = runs["port"][m]
    sums = jax.jit(lambda p, g: JS.ssim_l1_sums(p, g, None))
    got = sum(r["loss/sums"] for r in ranks)
    for i in range(pred.shape[0]):
        np.testing.assert_allclose(got[i], np.asarray(sums(jnp.asarray(pred[i]), jnp.asarray(gt[i]))), rtol=1e-5)
    loss = jax.jit(lambda p: JS.distributed_gs_loss(p, jnp.asarray(gt), lam=0.2))
    want_loss = np.asarray(loss(jnp.asarray(pred)))
    want_grad = np.asarray(jax.grad(loss)(jnp.asarray(pred)))
    h = pred.shape[1] // m
    scale = float(np.abs(want_grad).max())
    for j, r in enumerate(ranks):
        assert tuple(r["loss/coords"]) == (0, j)
        np.testing.assert_allclose(r["loss/loss"], want_loss, rtol=1e-5)
        np.testing.assert_allclose(r["loss/grad"], want_grad[:, j * h:(j + 1) * h], atol=2e-5 * scale, rtol=2e-4,
                                   err_msg=f"strip {j} of {m}")


# ---------------------------------------------------------------- shard balance


def test_shard_balance_over_four_shards_matches_jax(runs):
    want = runs["jax_balance"]
    for r in runs["port"][4]:
        assert json.loads(str(r["balance/balance"])) == want["balance"]
        snap = json.loads(str(r["balance/snapshot"]))
        assert {k: v for k, v in snap.items() if k.startswith("train.")} == \
            {k: v for k, v in want["snapshot"].items() if k.startswith("train.")}
    bal = want["balance"]
    assert bal["n_shards"] == 4 and bal["alive"][0] == 0 and bal["imbalance"] > 1.0


# ---------------------------------------------------------------- densify


@pytest.mark.parametrize("m", [2, 4])
def test_densify_and_rebalance_across_shards_matches_jax(runs, m):
    """Every rank runs the same round on the gathered state with the same
    generator: each keeps the matching row block of the JAX package's
    round, padded to ``m * pad_quantum``."""
    arrays = {k[len("d.state."):]: v for k, v in runs["inputs"].items() if k.startswith("d.state.")}
    jout, jrep = jax_densify(_jax_state(arrays), JGSConfig(**DENSIFY_CFG), n_shards=m,
                             rng=np.random.default_rng(11))
    assert jrep.n_cloned > 0 and jrep.n_split > 0 and jrep.n_pruned > 0
    assert jrep.n_padded % (m * DENSIFY_CFG["pad_quantum"]) == 0
    want = TR.flat_state(init_state(TG.GaussianModel(*[torch.zeros(1)] * 5)), "")  # keys only
    jflat = {k: np.asarray(v) for k, v in _flat_jax(jout).items()}
    k_rows = jrep.n_padded // m
    for j, r in enumerate(runs["port"][m]):
        assert tuple(r["densify/report"]) == tuple(jrep)
        for key in want:
            got, ref = r[f"densify/shard.{key}"], jflat[key]
            if key not in ("step", "adam.count"):
                ref = ref[j * k_rows:(j + 1) * k_rows]
            assert got.shape == ref.shape, key
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6, err_msg=f"shard {j} of {m}: {key}")
            np.testing.assert_array_equal(r[f"densify/gathered.{key}"], arrays[key], err_msg=f"gather_state {key}")
            np.testing.assert_array_equal(r[f"densify/restored.{key}"], got, err_msg=f"restored shard {key}")


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_checkpoint_holds_full_arrays_that_jax_restores(runs, m):
    """The densified shards of m ranks, saved with the mesh: one checkpoint
    of full arrays (rank 0 wrote it), equal to the ranks' blocks in order,
    that the JAX package restores."""
    from repro.checkpoint import restore_checkpoint as jax_restore
    from repro.core.train import init_state as jax_init_state

    ckpt = str(runs["tmp"] / f"ckpt{m}")
    ranks = runs["port"][m]
    step = int(ranks[0]["densify/shard.step"])
    like = jax.tree_util.tree_map(np.asarray, jax_init_state(JG.GaussianModel(*[jnp.zeros((1,) + s) for s in
                                                                               ((3,), (3,), (4,), (), (1, 3))])))
    back = _flat_jax(jax_restore(ckpt, step, like))
    assert int(back.pop("step")) == step and int(back.pop("adam.count")) == int(ranks[0]["densify/shard.adam.count"])
    for key, full in back.items():
        np.testing.assert_array_equal(full, np.concatenate([r[f"densify/shard.{key}"] for r in ranks]), err_msg=key)


def _flat_jax(state) -> dict:
    s = jax.tree_util.tree_map(np.asarray, state)
    out = {k: getattr(s, k) for k in ("step", "grad2d_accum", "vis_count", "max_radii")}
    out["adam.count"] = s.adam.count
    for part, mm in (("params", s.params), ("adam.m", s.adam.m), ("adam.v", s.adam.v)):
        out.update({f"{part}.{f}": x for f, x in zip(mm._fields, mm)})
    return out
