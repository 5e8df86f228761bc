"""Faults planted in the port's full-depth YOLOv4 serving step are caught
by the ``yolov4-stream`` cell's own check, on the card at the cell's size:
``drivers/stream_heads.checked_draws`` on the traffic's first draws, with
the cell's limits. Each test prints its readings.

    python -m pytest -p no:cacheprovider -q -s \
        h100_bench/test_bench_yolov4_faults.py

Forward faults read in ``head_gap``: one conv's bias dropped, mish run as
leaky in three convs of the third CSP stage or in the whole second one,
one SPP pool passed through.
Post-process faults read in ``post_gap``: NMS switched off, each class
cut to its best detection. Needs a CUDA device.
"""

import dataclasses
import json

import pytest

from h100_bench import run as harness

CELL = "yolov4-stream"
SEEDS = (2 ** 31 + 505, 2 ** 31 + 606)


def _bias_dropped(conv):
    def plant(spec, params):
        key = f"conv{conv}"
        params[key] = dict(params[key], bias=params[key]["bias"] * 0)
        return spec, params
    return plant


def _mish_as_leaky(first, last):
    def plant(spec, params):
        layers = list(spec.layers)
        for i in range(first, last + 1):
            if getattr(layers[i], "activation", None) == "mish":
                layers[i] = dataclasses.replace(layers[i],
                                                activation="leaky")
        return dataclasses.replace(spec, layers=layers), params
    return plant


def _spp_pool_skipped(which):
    def plant(spec, params):
        from modelcompression_tpu_torch.models.cfg import MaxPoolLayer
        layers = list(spec.layers)
        i = [j for j, l in enumerate(layers)
             if isinstance(l, MaxPoolLayer)][which]
        layers[i] = dataclasses.replace(layers[i], size=1, padding=0)
        return dataclasses.replace(spec, layers=layers), params
    return plant


FORWARD = {
    "bias_dropped_conv29": _bias_dropped(29),
    "bias_dropped_conv120": _bias_dropped(120),
    "mish_as_leaky_convs27_29": _mish_as_leaky(27, 29),
    "mish_as_leaky_csp_stage2": _mish_as_leaky(11, 23),
    "spp_pool5_skipped": _spp_pool_skipped(0),
    "spp_pool13_skipped": _spp_pool_skipped(2),
}


def _nms_off(orig):
    def nms_topk(boxes, scores, iou_thresh, *rest):
        return orig(boxes, scores, 2.0, *rest)
    return nms_topk


def _top_one(orig):
    from modelcompression_tpu_torch.evaluation.nms import _pad_slots

    def nms_topk(boxes, scores, iou_thresh, score_thresh, max_out, *rest):
        out = orig(boxes, scores, iou_thresh, score_thresh, 1, *rest)
        return _pad_slots(*out, 1, max_out)
    return nms_topk


POST = {"nms_switched_off": _nms_off, "k_cut_to_1": _top_one}


def _checked(seed, plant=None):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check runs at the cell's "
                    "own size")
    cell, config, traffic = harness.load_cell(CELL)
    driver = harness.load_module("drivers", traffic["driver"])
    check = driver.checked_draws(cell, config, traffic, seed, "cuda", plant)
    return harness.check_lines({"check": check, "limits": cell["check"],
                                "failed": 0})


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FORWARD))
def test_forward_fault_is_caught(fault, seed):
    correct, check = _checked(seed, FORWARD[fault])
    print(json.dumps({"fault": fault, "seed": seed, "check": check}))
    assert not correct
    assert check["head_gap"]["value"] > check["head_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(POST))
def test_post_process_fault_is_caught(monkeypatch, fault, seed):
    import modelcompression_tpu_torch.evaluation.nms as nms
    monkeypatch.setattr(nms, "nms_topk", POST[fault](nms.nms_topk))
    correct, check = _checked(seed)
    print(json.dumps({"fault": fault, "seed": seed, "check": check}))
    assert not correct
    assert check["post_gap"]["value"] > check["post_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_step_is_correct(seed):
    correct, check = _checked(seed)
    print(json.dumps({"fault": None, "seed": seed, "check": check}))
    assert correct
