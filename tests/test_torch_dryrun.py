"""PyTorch port, the dry run (``launch/dryrun.py``): every architecture's
serve step runs on ``configs/common.py``'s meta stand-ins (``decode_specs``
gives the position as a host scalar); ``run_dryrun`` on ``card1`` writes
every key of the JAX dry run's JSON that carries over, for qwen3-0.6b and
whisper-tiny at reduced shapes; a dense prefill's counted matmuls are the
model's linear layers exactly and its useful-flop ratio is the analytic
one within the elementwise share; a decode's peak counts its cache once;
``pod1`` adds the weights' collectives."""
import json

import pytest

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.common import SHAPES, ShapeCase, decode_specs, params_specs
from repro_torch.launch.dryrun import run_dryrun
from repro_torch.models import api
from repro_torch.models.params import tree_leaves

KEYS = {"arch", "shape", "mesh", "kind", "devices", "count_s", "memory_analysis", "flops", "bytes",
        "collective_moved_bytes", "roofline", "model_flops_per_chip", "useful_flop_ratio", "params_total",
        "params_active", "collectives_counted", "top_bytes", "by_op"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_estimate_bytes", "fits_80gb"}


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_serve_step_runs_on_the_meta_stand_ins(aid):
    cfg = get_arch(aid).config()
    specs = decode_specs(cfg, ShapeCase(512, 2, "decode"))
    logits, cache = api.make_serve_step(cfg)(params_specs(cfg), specs["cache"], specs["tokens"], specs["pos"])
    assert logits.device.type == "meta" and tuple(logits.shape) == (2, 1, cfg.vocab)
    assert cache is specs["cache"]


@pytest.mark.parametrize("arch,shape,seq", [("qwen3-0.6b", "prefill_32k", 256), ("whisper-tiny", "train_4k", 128),
                                            ("qwen3-0.6b", "decode_32k", None)])
def test_card1_dryrun_writes_every_key(tmp_path, arch, shape, seq):
    r = run_dryrun(arch, shape, mesh="card1", out_dir=str(tmp_path), seq_len=seq)
    saved = json.loads((tmp_path / f"{r['arch']}_{shape}_card1.json").read_text())
    assert KEYS <= set(saved) and MEMORY_KEYS == set(saved["memory_analysis"])
    assert saved["devices"] == 1 and saved["collective_moved_bytes"] == 0
    assert set(saved["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant"}
    assert saved["flops"] > 0 and saved["bytes"] > 0 and saved["memory_analysis"]["temp_bytes"] > 0
    if saved["kind"] != "decode":
        assert saved["by_op"]["flash_attention"]["count"] > 0


def test_decode_peak_counts_the_cache_once():
    """The cache is the step's argument, built before the count: it stands
    in ``argument_bytes`` and not again in ``temp_bytes``, which holds the
    step's temporaries (one layer's float32 K and V and their copies)."""
    cfg = get_arch("qwen3-0.6b").config()
    shape = SHAPES["decode_32k"]
    cache = api.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cache_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(cache))
    mem = run_dryrun("qwen3-0.6b", "decode_32k", mesh="card1")["memory_analysis"]
    assert cache_bytes <= mem["argument_bytes"] < 1.01 * cache_bytes
    assert mem["alias_bytes"] == cache_bytes
    assert mem["temp_bytes"] < cache_bytes / 4
    assert mem["peak_estimate_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]


def test_dense_prefill_counts_the_linear_layers_exactly_and_its_useful_ratio():
    """The prefill step's matmuls are 2 x (linear weights) per token plus the
    unembedding of each row's last token, exactly. The useful-flop ratio
    (2 x N x tokens over the count) then differs from 1 by the attention
    (4 x hd per unmasked pair, counted by the kernel's region), the
    unembedding that 2 N counts for every token but the step runs for the
    last one, and the elementwise ops (norms, RoPE, SwiGLU, casts): at 256
    tokens these are under 1% of the count, so the ratio lies within 1% of
    2 N tokens / (matmuls + attention)."""
    cfg = get_arch("qwen3-0.6b").config()
    s, b = 256, 32
    r = run_dryrun("qwen3-0.6b", "prefill_32k", seq_len=s)
    mm = sum(v["flops"] for k, v in r["by_op"].items() if k in ("mm", "bmm", "addmm"))
    params = params_specs(cfg)
    linear = sum(x.numel() for name, x in _named_leaves(params) if name.rsplit("/", 1)[-1].startswith("w"))
    assert mm == 2 * linear * b * s + 2 * cfg.vocab * cfg.d_model * b
    attn = r["by_op"]["flash_attention"]["flops"]
    analytic = r["model_flops_per_chip"] / (mm + attn)
    assert abs(r["useful_flop_ratio"] - analytic) / analytic < 0.01
    assert r["model_flops_per_chip"] == 2 * cfg.active_param_count() * b * s


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_pod_mesh_divides_the_count_and_adds_the_weights_collectives():
    one = run_dryrun("qwen3-0.6b", "train_4k", mesh="card1", seq_len=128)
    pod = run_dryrun("qwen3-0.6b", "train_4k", mesh="pod1", seq_len=128)
    assert pod["devices"] == 256 and pod["per_card"] == "global count / cards"
    assert pod["flops"] == pytest.approx(one["flops"] / 256)
    assert pod["memory_analysis"]["argument_bytes"] < one["memory_analysis"]["argument_bytes"] / 8
    assert pod["collectives_counted"] == "weights only" and pod["collective_moved_bytes"] > 0
    kinds = {k.split(" over ")[0] for k in pod["collectives"]}
    assert {"all-gather", "reduce-scatter"} <= kinds
    assert pod["roofline"]["collective_s"] > 0


def test_roofline_table_and_grid_read_the_sweep(tmp_path):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    import roofline_torch

    r = run_dryrun("qwen3-0.6b", "prefill_32k", mesh="card1", out_dir=str(tmp_path), seq_len=128)
    rows = []
    roofline_torch.table(rows.append, dirname=str(tmp_path))
    peak_gb = r["memory_analysis"]["peak_estimate_bytes"] / 1e9
    assert rows[0].endswith(",peak_gb") and rows[1].startswith("qwen3-0.6b,prefill_32k,")
    assert rows[1].endswith(f",{peak_gb:.1f}")
    grid = []
    roofline_torch.grid(grid.append, dirname=str(tmp_path))
    cell = grid[2].split(" | ")[2]
    assert grid[2].startswith("| qwen3-0.6b | not counted | ") and cell.endswith(f" {peak_gb:.1f}")
