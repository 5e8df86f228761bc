"""The port's YOLOv4 serving path against the benchmark's plain reference
(``h100_bench/reference``, plain PyTorch that imports neither the port
nor JAX), on the CPU.

* A toy YOLOv4 (``h100_bench/testdata/tiny-yolov4.cfg``: every section
  kind of ``yolov4-voc.cfg``) served by the ``yolov4-stream`` cell's
  driver (``drivers/stream_heads``) through ``make_eval_step`` on seeded
  weights and frames, judged under the cell's serving settings, band and
  limits: its head maps against the reference's forward in fp32, in
  units of a plain bf16 reference's distance from it (``head_gap``), its
  detections against the reference's decode and NMS of those maps
  (``post_gap``). BITMATCH at round-off, FAST inside the limits, the
  float8 control far above FAST, and broken paths caught.
* The full-depth ``yolov4-voc.cfg`` at 96x96 in BITMATCH: the three head
  maps against the reference's, both held to a float64 run of the
  reference.
"""

import json
import os
import time

import pytest
import torch
import torch.nn.functional as F

from h100_bench import inputs, run as harness
from h100_bench.reference import cfg as refcfg, detect, model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "h100_bench")
TINY = os.path.join(BENCH, "testdata", "tiny-yolov4.cfg")
YOLOV4_VOC = os.path.join(ROOT, "modelcompression_tpu_torch", "configs",
                          "yolov4-voc.cfg")
with open(os.path.join(BENCH, "workloads", "yolov4-stream.json")) as f:
    CELL = json.load(f)
SEEDS = (2 ** 31 + 29, 41)


@pytest.fixture(autouse=True)
def one_thread():
    """Toy sizes on one thread: under the suite's parallel workers the
    default thread count oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bitmatch(monkeypatch):
    """Run the port's serving step in fp32."""
    from modelcompression_tpu_torch.core.precision import BITMATCH
    import modelcompression_tpu_torch.evaluation as ev
    make = ev.EvalConfig
    monkeypatch.setattr(ev, "EvalConfig", lambda **kw: make(
        **dict(kw, precision=BITMATCH)))


def _toy():
    cell = dict(CELL, name="toy-yolov4")
    traffic = {"driver": "stream_heads", "batch": 4, "src_h": 48,
               "src_w": 64, "pool": 12, "depth": 2, "warmup_batches": 1,
               "trace_batches": 2, "check_batches": 2}
    return cell, {"cfg": TINY}, traffic


def _driver():
    return harness.load_module("drivers", "stream_heads")


def _check(seed, plant=None):
    """``stream_heads``' check of the port's step on the traffic's first
    two draws, without its timed window (whose count of batches depends
    on the CPU's load)."""
    cell, config, traffic = _toy()
    out = {"check": _driver().checked_draws(cell, config, traffic, seed,
                                            "cpu", plant),
           "limits": cell["check"], "failed": 0}
    return harness.check_lines(out)


def test_driver_run_reports_both_parts():
    """One timed run of ``stream_heads``: the loop hands the sampled batches'
    maps to the check, and the run reads as a stream run."""
    cell, config, traffic = _toy()
    out = _driver().run(
        cell=cell, config=config, traffic=traffic, seed=SEEDS[0],
        seconds=8.0, trace=False, t0=time.monotonic(), device="cpu")
    assert out["driver"] == "stream"
    assert out["notes"]["batches_compared"] >= 1
    correct, check = harness.check_lines(out)
    assert correct, check
    assert set(check) == set(CELL["check"]) == {"head_gap", "post_gap"}


def test_config_file_agrees_with_its_cfg():
    """The cell's cfg is the port's bundled ``yolov4-voc.cfg`` text for
    text, and the configuration's sizes are what the cfg implies."""
    from h100_bench.reference import arith
    with open(os.path.join(BENCH, "configs", "yolov4-voc-416.json")) as f:
        config = json.load(f)
    with open(inputs.cfg_path(config)) as f, open(YOLOV4_VOC) as g:
        assert f.read() == g.read()
    net, layers = refcfg.read(YOLOV4_VOC)
    convs = [l for l in layers if l["type"] == "conv"]
    assert config["convs"] == len(convs) == 110
    assert config["conv_weights"] == sum(
        l["filters"] * l["in_c"] * l["size"] ** 2 for l in convs)
    assert config["gflop_per_img"] == arith.conv_flops(layers) / 1e9
    heads = [l for l in layers if l["type"] == "yolo"]
    assert (config["heads"], config["classes"], config["anchors_per_cell"],
            config["height"], config["width"], config["reduced"]) == (
        len(heads), heads[0]["classes"], len(heads[0]["anchors"]),
        int(net["height"]), int(net["width"]), [])


def test_toy_has_every_section_kind_of_yolov4_voc():
    def kinds(path):
        _, layers = refcfg.read(path)
        out = {l["type"] for l in layers}
        out |= {"act:" + l["act"] for l in layers if l["type"] == "conv"}
        out |= {f"route{len(l['layers'])}" for l in layers
                if l["type"] == "route"}
        out |= {f"pool{l['size']}s{l['stride']}" for l in layers
                if l["type"] == "maxpool"}
        return out
    assert kinds(TINY) == kinds(YOLOV4_VOC)
    _, layers = refcfg.read(TINY)
    scales = [l["scale_x_y"] for l in layers if l["type"] == "yolo"]
    assert len(set(scales)) == len(scales) == 3


@pytest.mark.parametrize("seed", SEEDS)
def test_bitmatch_serving_matches_the_reference(bitmatch, seed):
    _, check = _check(seed)
    assert check["head_gap"]["value"] < 1e-4
    assert check["post_gap"]["value"] < 1e-3


@pytest.mark.parametrize("seed", SEEDS)
def test_fast_serving_within_the_cells_limits(seed):
    correct, check = _check(seed)
    assert correct, check


@pytest.mark.parametrize("seed", SEEDS)
def test_control_reads_far_above_the_program(seed):
    """The float8 control against FAST on the same seed and frames: at
    least 5x FAST (the toy reads FAST 1.06-1.28 and the control
    12.7-13.7; PERF.md gives the cell's readings at 416)."""
    cell, config, traffic = _toy()
    got = _driver().control(cell, config, traffic, seed, "cpu")
    _, fast = _check(seed)
    assert got["head_gap"] > 5 * fast["head_gap"]["value"]
    # the control's detections are its own decode and NMS of its maps
    assert got["post_gap"] == 0.0


def _nms_off(orig):
    """Greedy NMS that suppresses nothing."""
    def nms_topk(boxes, scores, iou_thresh, *rest):
        return orig(boxes, scores, 2.0, *rest)
    return nms_topk


def _top_one(orig):
    """Each class's top 1 candidate kept in place of its top K."""
    from modelcompression_tpu_torch.evaluation.nms import _pad_slots

    def nms_topk(boxes, scores, iou_thresh, score_thresh, max_out, *rest):
        out = orig(boxes, scores, iou_thresh, score_thresh, 1, *rest)
        return _pad_slots(*out, 1, max_out)
    return nms_topk


@pytest.mark.parametrize("fault", [_nms_off, _top_one],
                         ids=["nms_switched_off", "k_cut_to_1"])
def test_post_process_fault_is_caught(monkeypatch, fault):
    import modelcompression_tpu_torch.evaluation.nms as nms
    monkeypatch.setattr(nms, "nms_topk", fault(nms.nms_topk))
    correct, check = _check(SEEDS[0])
    assert not correct
    assert check["post_gap"]["value"] > check["post_gap"]["limit"]


def _route_reversed(darknet, monkeypatch):
    """Every route source's channels in reverse order."""
    monkeypatch.setattr(darknet, "route_part", lambda t, l: t.flip(1))


def _pools_skipped(darknet, monkeypatch):
    """SPP's max pools passed through."""
    monkeypatch.setattr(darknet, "maxpool", lambda x, l: x)


def _mish_as_leaky(darknet, monkeypatch):
    """Every mish run as leaky (the toy reads 34 against FAST's 1.06)."""
    act = darknet._activate
    monkeypatch.setattr(darknet, "_activate", lambda x, kind: act(
        x, "leaky" if kind == "mish" else kind))


@pytest.mark.parametrize("fault", [_route_reversed, _pools_skipped,
                                   _mish_as_leaky],
                         ids=["route_reversed", "spp_pools_skipped",
                              "mish_as_leaky"])
def test_forward_fault_is_caught(monkeypatch, fault):
    from modelcompression_tpu_torch.models import darknet
    fault(darknet, monkeypatch)
    correct, check = _check(SEEDS[0])
    assert not correct
    assert check["head_gap"]["value"] > check["head_gap"]["limit"]


def _at(size: int) -> str:
    with open(YOLOV4_VOC) as f:
        return f.read().replace("width=416", f"width={size}").replace(
            "height=416", f"height={size}")


def test_full_depth_yolov4_voc_head_maps_match_the_reference():
    """Bias added after the conv and channels-last convs (the port)
    against the bias inside NCHW convs (the reference): two fp32 orders of
    the same sums. Neither may sit farther from a float64 run of the
    function than the other by more than a factor of 3 (the two read
    within 1.6x of each other at this size), which a wrong layer, route or
    activation would break by orders of magnitude."""
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.models import fold_batchnorm, parse_cfg
    from modelcompression_tpu_torch.models.darknet import forward_folded
    text = _at(96)
    net, layers = refcfg.parse(text)
    pool = inputs.frame_pool(8, 72, 96, SEEDS[0], "cpu")
    raw = inputs.raw_params(net, layers, SEEDS[0], "cpu", pool)
    x = detect.letterbox(torch.as_tensor(pool[:2]), 96, 96)
    folded = model.fold(raw, layers)
    ref = model.forward(folded, layers, x)
    wide = {k: {n: v.double() for n, v in p.items()}
            for k, p in folded.items()}

    def conv64(i, l, y):
        p = wide[f"conv{i}"]
        return F.conv2d(y.double(), p["w"], p["bias"], stride=l["stride"],
                        padding=l["pad"])

    with torch.no_grad():
        ref64 = model._walk(layers, x, conv64)
        spec = parse_cfg(text)
        port = forward_folded(fold_batchnorm(raw, spec), x.permute(0, 2, 3, 1),
                              spec, BITMATCH)
    assert len(port) == len(ref) == len(ref64) == 3
    for p, r, r64 in zip(port, ref, ref64):
        p = p.permute(0, 3, 1, 2)
        assert p.shape == r.shape
        port_gap = (p.double() - r64).abs().max()
        ref_gap = (r.double() - r64).abs().max()
        assert port_gap <= 3 * ref_gap
        assert port_gap < 1e-4 * r64.abs().max()


def _event(name, kernels=(), children=(), device="cpu"):
    from types import SimpleNamespace
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, device_type=getattr(DeviceType, device.upper()),
        kernels=[SimpleNamespace(name=k) for k in kernels],
        cpu_children=list(children),
        time_range=SimpleNamespace(start=0.0, end=1.0))


def test_forward_launches_splits_the_convolutions_off():
    """Device operations under each ``mc.serve.forward`` range, those of a
    conv op's subtree apart; the range's own annotation, the device-side
    copy of the range and other ranges are not counted."""
    conv = _event("aten::conv2d", children=[_event(
        "aten::convolution", children=[_event(
            "aten::cudnn_convolution", ["sm90_xmma_fprop", "nchwToNhwc"])])])
    forward = _event("mc.serve.forward", ["mc.serve.forward"], [
        _event("aten::to", ["copy"]), conv,
        _event("aten::add", ["add"]),
        _event("aten::softplus", ["softplus"]),
        _event("aten::view")])
    events = [forward, _event("mc.serve.forward", ["k"], device="cuda"),
              _event("mc.serve.postprocess", ["nms"], [
                  _event("aten::conv2d", ["k"])])]
    assert _driver().forward_launches(events * 2) == [(5, 2), (5, 2)]


def test_forward_launches_finds_the_steps_ranges_on_the_cpu():
    """The port's step under the profiler, as the driver's traced window
    takes it: one range a step, and in it conv ops with the ops they call
    and ops outside them (counted here one a leaf op; on the CPU no op
    launches device work)."""
    from torch.profiler import ProfilerActivity, profile
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models import (
        fold_batchnorm, init_params,
    )
    from modelcompression_tpu_torch.models.cfg import load_cfg
    spec = load_cfg(TINY)
    params = fold_batchnorm(init_params(spec, seed=0), spec)
    step = make_eval_step(spec, EvalConfig(
        conf_thresh=0.01, max_detections=8, nms_prefilter=32,
        precision=FAST, device="cpu"))
    n = spec.net.height
    images = torch.zeros((1, n, n, 3), dtype=torch.uint8)
    sizes = torch.full((1,), float(n))
    step(params, images, sizes, sizes)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            step(params, images, sizes, sizes)
    events = prof.events()
    convs = sum(1 for l in spec.layers if type(l).__name__ == "ConvLayer")
    leaves = _driver().forward_launches(
        events, launches=lambda e: 0 if e.cpu_children else 1)
    assert len(leaves) == 3
    assert all(conv >= convs and total - conv >= convs
               for total, conv in leaves)
    assert leaves[0] == leaves[1] == leaves[2]
    assert _driver().forward_launches(events) == [(0, 0)] * 3
