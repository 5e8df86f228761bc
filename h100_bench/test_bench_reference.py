"""The plain reference against the port at toy sizes on the CPU: with
the port in fp32 (BITMATCH) both compute the same function, so every
number the check compares reads at round-off."""

import os
import time

import numpy as np
import pytest
import torch

from h100_bench import inputs, run as harness
from h100_bench.reference import cfg, detect, model, prune

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = {"region": os.path.join(HERE, "testdata", "tiny-region.cfg"),
        "yolo": os.path.join(HERE, "testdata", "tiny-yolo.cfg")}
SERVING = {"conf": 0.01, "nms": 0.45, "max_detections": 32,
           "nms_prefilter": 128}
BAND = {"score": 0.07, "iou": 0.1, "match": 0.05}


@pytest.fixture
def bitmatch(monkeypatch):
    """Run the port's serving step in fp32."""
    from modelcompression_tpu_torch.core.precision import BITMATCH
    import modelcompression_tpu_torch.evaluation as ev
    make = ev.EvalConfig
    monkeypatch.setattr(ev, "EvalConfig", lambda **kw: make(
        **dict(kw, precision=BITMATCH)))


def _stream(kind, recipe):
    cell = {"name": "toy", "chips": 1, "recipe": recipe, "serving": SERVING,
            "check": {"det_gap": 1.0}, "match_band": BAND}
    traffic = {"driver": "stream", "batch": 4, "src_h": 48, "src_w": 64,
               "pool": 12, "depth": 2, "warmup_batches": 1,
               "trace_batches": 2, "check_batches": 2}
    return cell, {"cfg": TINY[kind]}, traffic


@pytest.mark.parametrize("kind,recipe", [
    ("region", {"prune": "l1_filter", "fraction": 0.75}),
    ("yolo", None)])
def test_serving_matches_the_port(bitmatch, kind, recipe):
    cell, config, traffic = _stream(kind, recipe)
    out = harness.load_module("drivers", "stream").run(
        cell=cell, config=config, traffic=traffic, seed=2 ** 31 + 17,
        seconds=3.0, trace=False, t0=time.monotonic(), device="cpu")
    assert out["notes"]["batches_compared"] >= 1
    assert out["check"]["det_gap"] < 1e-3


def test_keep_sets_and_repack_match_the_port():
    from modelcompression_tpu_torch.compress.criteria import (
        l1_filter_keep_sets,
    )
    from modelcompression_tpu_torch.compress.repack import repack
    from modelcompression_tpu_torch.models.cfg import load_cfg
    path = os.path.join(HERE, "configs", "yolov2-voc-416.cfg")
    net, layers = cfg.read(path)
    gen = torch.Generator().manual_seed(3)
    raw = {}
    for i, l in enumerate(layers):
        if l["type"] == "conv":
            raw[f"conv{i}"] = {"w": torch.randn(
                (l["filters"], l["in_c"], l["size"], l["size"]),
                generator=gen)}
    ref_keep = prune.keep_sets(raw, layers, 0.75)
    spec = load_cfg(path)
    port_keep = l1_filter_keep_sets(raw, spec, 0.75)
    assert ref_keep.keys() == port_keep.keys()
    for i in ref_keep:
        np.testing.assert_array_equal(ref_keep[i], port_keep[i])
    slim, ref_p = prune.repack(raw, net, layers, ref_keep)
    _, port_p = repack(spec, raw, port_keep)
    for k in ref_p:
        assert torch.equal(ref_p[k]["w"], port_p[k]["w"])


@pytest.mark.parametrize("kind", ["region", "yolo"])
def test_control_reads_above_the_program(kind):
    """At toy size too, float8 conv operands move the detections far more
    than the served path's own rounding does."""
    net, layers = cfg.read(TINY[kind])
    pool = inputs.frame_pool(12, 48, 64, 5, "cpu")
    raw = inputs.raw_params(net, layers, 5, "cpu", pool)
    folded = model.fold(raw, layers)
    frames = torch.as_tensor(pool[:8])
    ref = detect.serve(folded, net, layers, frames, SERVING)
    low = detect.serve(folded, net, layers, frames, SERVING, lowp="fp8")
    same = detect.compare(ref["det"], ref, SERVING, BAND)
    gaps = detect.compare(low["det"], ref, SERVING, BAND)
    assert same["det_gap"] == 0.0
    assert gaps["det_gap"] > 0.01
