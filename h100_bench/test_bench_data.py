"""The harness reads cells and metrics as data: ``BENCHMARK.json``'s
entries each have their files, and a cell or a per-layer metric added as
new files alone is found by its name."""

import importlib.util
import json
import os
import re
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _harness(root):
    spec = importlib.util.spec_from_file_location(
        "copied_run", os.path.join(root, "h100_bench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["h100_bench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    assert {w["config"] for w in b["workloads"]} == configs
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for entry in (*b["configs"], *b["workloads"], *b["end_to_end"],
                  *b["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200, entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_entry_has_its_files():
    b = _bench()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(HERE, "configs", data["cfg"]))
    for w in b["workloads"]:
        with open(os.path.join(HERE, "workloads", w["name"] + ".json")) as f:
            cell = json.load(f)
        assert (cell["config"], cell["traffic"], cell["chips"],
                cell["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
        with open(os.path.join(HERE, "traffic",
                               w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(HERE, "drivers",
                                           driver + ".py"))
        assert cell["check"], w["name"]
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "layer_metrics",
                                           m["name"] + ".py"))


def test_added_cell_and_metric_are_found(tmp_path):
    shutil.copytree(HERE, tmp_path / "h100_bench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    cells = tmp_path / "h100_bench" / "workloads"
    with open(cells / "yolov2-p75-stream.json") as f:
        cell = json.load(f)
    cell["why"] = "a cell added as a file"
    with open(cells / "added-cell.json", "w") as f:
        json.dump(cell, f)
    (tmp_path / "h100_bench" / "layer_metrics" / "added_metric.x.py"
     ).write_text("def read(run):\n    return run['rate'] * 2\n")
    harness = _harness(str(tmp_path))
    got, config, traffic = harness.load_cell("added-cell")
    assert got["why"] == "a cell added as a file"
    assert config["name"] == "yolov2-voc-416"
    assert traffic["driver"] == "stream"
    values = harness.per_layer_values(
        {"rate": 21.0}, [{"name": "added_metric.x", "unit": "img/s",
                          "workloads": ["added-cell"]}], "added-cell")
    assert values == {"added_metric.x": {"value": 42.0, "unit": "img/s"}}


def test_reader_with_nothing_to_read_is_left_out():
    harness = _harness(ROOT)
    run = {"driver": "stream", "trace": {"ops": {}, "busy_s": 1.0,
                                         "window_s": 2.0},
           "shapes": {"batch": 64, "net_h": 416, "net_w": 416,
                      "conv1_filters": 8}}
    out = harness.per_layer_values(
        run, [{"name": "input_stage_roofline.serve", "unit": "%"},
              {"name": "device_idle.serve", "unit": "%"}], "any")
    assert out == {"device_idle.serve": {"value": 50.0, "unit": "%"}}


def test_check_lines_need_every_limit():
    harness = _harness(ROOT)
    ok, check = harness.check_lines({"check": {"a": 0.1},
                                     "limits": {"a": 0.2, "b": 1.0},
                                     "failed": 0})
    assert not ok and check["b"]["value"] == float("inf")
    ok, _ = harness.check_lines({"check": {"a": 0.1, "b": 0.5},
                                 "limits": {"a": 0.2, "b": 1.0},
                                 "failed": 0})
    assert ok


def test_no_cuda_exits_without_a_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    harness = _harness(ROOT)
    rc = harness.main(["--workload", "yolov2-p75-stream", "--seed",
                       str(2 ** 31 + 5), "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
