"""The frozen FLOP and roofline arithmetic against the numbers the
repository's PERF.md records for the port. YOLOv4-VOC, which no cell
serves yet, is read from the port's bundled cfg."""

import os

import pytest

from h100_bench.reference import arith, cfg

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(HERE, "configs")
CFGS = {"yolov2-voc-416": os.path.join(CONFIGS, "yolov2-voc-416.cfg"),
        "yolov4-voc-416": os.path.join(os.path.dirname(HERE),
                                       "modelcompression_tpu_torch",
                                       "configs", "yolov4-voc.cfg")}


def _layers(name):
    return cfg.read(CFGS[name])


@pytest.mark.parametrize("name,gflop,convs,weights", [
    ("yolov2-voc-416", 29.36, 23, 50_634_592),
    ("yolov4-voc-416", 59.67, 110, 63_973_472),
])
def test_conv_flops(name, gflop, convs, weights):
    _, layers = _layers(name)
    assert round(arith.conv_flops(layers) / 1e9, 2) == gflop
    assert len(cfg.conv_indices(layers)) == convs
    assert sum(l["filters"] * l["in_c"] * l["size"] ** 2
               for l in layers if l["type"] == "conv") == weights


def test_pruned_flops():
    net, layers = _layers("yolov2-voc-416")
    last = cfg.head_indices(layers)[0] - 1
    slim = cfg.with_filters(net, layers, {
        i: layers[i]["filters"] - int(0.75 * layers[i]["filters"])
        for i in cfg.conv_indices(layers) if i != last})
    assert round(arith.conv_flops(slim) / 1e9, 2) == 1.90
    assert slim[0]["filters"] == 8


@pytest.mark.parametrize("filters,ms", [(32, 0.0727), (8, 0.0331)])
def test_input_stage_bound(filters, ms):
    assert round(arith.input_stage_bound_s(64, 416, 416, filters) * 1e3,
                 4) == ms


def test_config_files_agree_with_cfgs():
    import json
    for name in ("yolov2-voc-416",):
        with open(os.path.join(CONFIGS, name + ".json")) as f:
            c = json.load(f)
        _, layers = _layers(name)
        assert c["convs"] == len(cfg.conv_indices(layers))
        assert c["gflop_per_img"] == arith.conv_flops(layers) / 1e9
