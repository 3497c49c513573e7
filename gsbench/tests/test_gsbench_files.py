"""Every configuration, traffic, cell and metric of BENCHMARK.json has its
file, parses, and is found by name; the cell files agree with
BENCHMARK.json."""
import json
import os

from conftest import ROOT

from gsbench.harness import load_cell, metric_readers


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_is_found_by_name_and_agrees_with_the_benchmark():
    bench = _bench()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert cell["config_data"]["name"] == w["config"]
        assert set(cell["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
        mesh = cell["mesh"]
        assert (mesh is None and w["chips"] == 1) or mesh[0] * mesh[1] == w["chips"]
        c = configs[w["config"]]
        assert c["file"] == f"gsbench/configs/{w['config']}.json"
        assert cell["config_data"]["reduced"] == c["reduced"]
        assert cell["config_data"]["source"] == c["source"] and cell["config_data"]["why"] == c["why"]


def test_every_configuration_lists_its_cuts():
    for fn in os.listdir(os.path.join(ROOT, "gsbench", "configs")):
        with open(os.path.join(ROOT, "gsbench", "configs", fn)) as f:
            c = json.load(f)
        assert fn == f"{c['name']}.json"
        assert set(c["reduced"]) <= set(c) and set(c["reduced"]) <= set(c["assumed"])
        assert c["views"] < c["views_published"] and c["densify"] is False


def test_every_per_layer_metric_has_a_reader_with_its_unit():
    readers = metric_readers()
    bench = _bench()
    for m in bench["per_layer"]:
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].UNIT == m["unit"]
        assert callable(readers[m["name"]].read)
    assert set(readers) == {m["name"] for m in bench["per_layer"]}


def test_the_command_and_paths():
    bench = _bench()
    assert bench["command"] == ["python3", "gsbench/run.py"]
    assert bench["paths"] == ["gsbench"]
    assert {m["name"] for m in bench["end_to_end"]} == {"step_ms", "step_ms_p90", "peak_mem_gb", "setup_s"}


def test_every_per_layer_metric_lists_the_cells_its_reader_reads():
    """Each reader reads in every cell, but the collectives' only where
    there are several chips."""
    bench = _bench()
    cells = [w["name"] for w in bench["workloads"]]
    mesh = [w["name"] for w in bench["workloads"] if w["chips"] > 1]
    for m in bench["per_layer"]:
        assert m["workloads"] == (mesh if m["name"] == "nccl_ms" else cells), m["name"]
