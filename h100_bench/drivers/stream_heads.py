"""Closed-loop batch serving as ``stream`` runs it, checked in two parts:
for a network so deep that rounding alone reorders its detections
(YOLOv4 at 416: the served bf16 path and the fp8 control stray alike from
the fp32 reference's detections), the forward and the post-process are
held to the reference apart.

The loop, its feed, its spans and its metrics are ``stream``'s (the run
reports ``"driver": "stream"``, which the per-layer readers read). The
serving step is built with ``raw_maps`` and hands its head maps out
beside its detections, as device tensors; the loop keeps them for the
batches it samples and fetches nothing more. After the window:

* ``head_gap``: the sampled batches' head maps against the reference's
  forward on the same frames, in fp32 and in plain bf16 (bf16 operands
  and results, ``reference_maps``): per head the root mean square of the
  port's difference from the fp32 maps over that of the bf16 reference's,
  the worst over heads and batches. A sound bf16 port reads about 1;
  rounding one step coarser, or a wrong layer, reads several times that;
* ``post_gap``: the served detections against the reference's decode
  and NMS run on the step's own head maps (``maps_served``), by
  ``reference.detect.compare`` under the cell's ``match_band``: the
  step's decode, NMS and map to source pixels alone.

The weights are ``inputs.raw_params``' with each BN gamma halved, to
[0.25, 0.75), and the BN statistics calibrated again (``seeded_params``):
with gamma in [0.5, 1.5) a random network of YOLOv4's depth carries bf16
rounding to 16-23% of the head maps' spread and the fp8 control to
61-72%, too close to tell a subtle fault from rounding; halved, 4-6% and
34-39%.

The traced window also counts the device operations the forward
launches outside its convolutions (``forward_launches``), which
``layer_metrics/epilogue_ops.serve`` reads.

``run`` is ``stream.run`` line for line but for the step's ``raw_maps``,
``_MapsLoop``, the weights, the check and the notes: a change to either
copy's set-up, warm-up, window or trace belongs in the other too.
"""

from __future__ import annotations

import contextlib
import random
import time
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from h100_bench import inputs, trace as tracing
from h100_bench.drivers.stream import _Loop, sync
from h100_bench.reference import arith, cfg as refcfg, detect, model, prune


GAMMA_SCALE = 0.5


def seeded_params(net, layers, seed, device, pool):
    """``inputs.raw_params`` with each BN gamma times ``GAMMA_SCALE`` and
    the BN running statistics calibrated again on the same frames, as if
    gamma had been drawn in [0.25, 0.75)."""
    raw = inputs.raw_params(net, layers, seed, device, pool)
    for p in raw.values():
        if "gamma" in p:
            p["gamma"].mul_(GAMMA_SCALE)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    model.strict_fp32()
    model.calibrate_bn(raw, layers, detect.letterbox(
        torch.as_tensor(pool[:inputs.CALIBRATION_FRAMES], device=device),
        int(net["height"]), int(net["width"])))
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags
    return raw


def serving_step(cell, path, raw, src_hw, device, plant=None):
    """The port's spec, serving params and step (``raw_maps`` on) for the
    cell's recipe and serving settings. ``plant(spec, params)``, if
    given, returns an altered spec and params (a planted fault)."""
    from modelcompression_tpu_torch.cli.common import prepare_serving
    from modelcompression_tpu_torch.compress.criteria import (
        l1_filter_keep_sets,
    )
    from modelcompression_tpu_torch.compress.repack import repack
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models.cfg import load_cfg
    spec, params = load_cfg(path), raw
    recipe = cell.get("recipe")
    if recipe:
        keep = l1_filter_keep_sets(raw, spec, recipe["fraction"])
        spec, params = repack(spec, raw, keep)
    serving = cell["serving"]
    ecfg = EvalConfig(conf_thresh=serving["conf"],
                      nms_thresh=serving["nms"],
                      max_detections=serving["max_detections"],
                      nms_prefilter=serving["nms_prefilter"],
                      precision=FAST, device=device)
    params, ecfg = prepare_serving(spec, params, False, ecfg)
    if plant is not None:
        spec, params = plant(spec, params)
    return spec, params, make_eval_step(spec, ecfg, src_hw=src_hw,
                                        raw_maps=True)


class _MapsLoop(_Loop):
    """``stream``'s loop, whose fetched batches carry the step's head maps
    (left on the device) as a third item."""

    def dispatch(self, spans: bool):
        ctx = tracing.span if spans else (lambda _: contextlib.nullcontext())
        with ctx("feed"):
            idx, frames = self._next()
        with ctx("step"):
            t = time.perf_counter()
            outs = self.step(self.params, frames, self.img_w, self.img_h)
            self.enqueue_s.append(time.perf_counter() - t)
        prev, self.pending = self.pending, (idx, outs[:3], outs[5:])
        if prev is None:
            return None
        with ctx("fetch"):
            return prev[0], self.fetch_batch(prev[1]), prev[2]

    def drain(self):
        prev, self.pending = self.pending, None
        return None if prev is None else (prev[0],
                                          self.fetch_batch(prev[1]), prev[2])


def forward_launches(events, span: str = "mc.serve.forward",
                     launches=None) -> List[Tuple[int, int]]:
    """Device operations launched under each of the port's ``span``
    ranges in a profiler's events, in the order the ranges start: the
    kernels, copies and sets the trace links to the host ops inside the
    range, and of those, the ones of ``aten`` conv ops and the ops they
    call. ``launches(event)`` counts an event's own (default: its linked
    device operations, less range annotations)."""
    from torch.autograd import DeviceType
    if launches is None:
        def launches(e):
            return sum(1 for k in e.kernels
                       if not k.name.startswith(("mc.", tracing.SPAN_PREFIX)))

    def walk(e, in_conv: bool) -> Tuple[int, int]:
        in_conv = in_conv or (e.name.startswith("aten::")
                              and "conv" in e.name)
        n = launches(e)
        total, conv = n, n if in_conv else 0
        for c in e.cpu_children:
            t, cv = walk(c, in_conv)
            total, conv = total + t, conv + cv
        return total, conv

    ranges = sorted((e for e in events if e.name == span
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    return [walk(e, False) for e in ranges]


def _traced(steps):
    """``trace.traced``'s reduction of the window, and
    ``forward_launches`` of the same events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
    events = prof.events()
    return tracing.summarize(events), forward_launches(events)


def head_gap(maps: List[torch.Tensor], ref_maps: List[torch.Tensor],
             bf16_maps: List[torch.Tensor]) -> float:
    """Worst over heads of rms(maps - fp32 reference) over rms(bf16
    reference - fp32 reference), NCHW."""
    def rms(a, b):
        return (a.float() - b).square().mean().sqrt()
    return max(float(rms(m, r) / rms(b, r))
               for m, r, b in zip(maps, ref_maps, bf16_maps))


def reference_maps(folded, net, layers, frames_u8, lowp=None,
                   chunk: int = 16) -> List[torch.Tensor]:
    """The reference's head maps (NCHW fp32) of source frames: in fp32,
    in the fp8 control (``lowp="fp8"``), or in plain bf16
    (``lowp="bf16"``: each conv's operands and bias, its result and what
    follows it, activations, adds, pools and routes, in bf16)."""
    net_h, net_w = int(net["height"]), int(net["width"])

    def bf16_conv(i, l, y):
        p = folded[f"conv{i}"]
        return F.conv2d(y.bfloat16(), p["w"].bfloat16(),
                        p["bias"].bfloat16(), stride=l["stride"],
                        padding=l["pad"])

    def forward(x):
        if lowp != "bf16":
            return model.forward(folded, layers, x, lowp=lowp)
        with torch.no_grad():
            return [h.float() for h in model._walk(layers, x, bf16_conv)]

    parts = [forward(detect.letterbox(frames_u8[lo:lo + chunk], net_h,
                                      net_w))
             for lo in range(0, frames_u8.shape[0], chunk)]
    return [torch.cat(p) for p in zip(*parts)]


def maps_served(maps: List[torch.Tensor], layers, net, src_hw,
                serving: Dict, chunk: int = 16) -> Dict[str, object]:
    """``detect.serve``'s output from given head maps (NCHW) in place of
    its own forward: the reference's decode and NMS of those maps."""
    heads = [l for l in layers if l["type"] in ("yolo", "region")]
    net_h, net_w = int(net["height"]), int(net["width"])
    r = detect.letterbox_geometry(*src_hw, net_h, net_w)[0]
    outs = []
    for lo in range(0, maps[0].shape[0], chunk):
        boxes, scores = detect.decode([m[lo:lo + chunk].float()
                                       for m in maps], heads, net_h, net_w)
        db, ds, dv = detect.nms(boxes, scores, serving["conf"],
                                serving["nms"], serving["max_detections"],
                                serving["nms_prefilter"])
        side = torch.maximum((boxes[..., 2] - boxes[..., 0]) * net_w,
                             (boxes[..., 3] - boxes[..., 1]) * net_h) / r
        outs.append((boxes, detect.to_pixels(boxes, *src_hw, net_h, net_w),
                     side, scores, detect.to_pixels(db, *src_hw, net_h,
                                                    net_w), ds, dv))
    norm, boxes, side, scores, db, ds, dv = (torch.cat(p)
                                             for p in zip(*outs))
    return {"norm": norm, "boxes": boxes, "side": side, "scores": scores,
            "det": (db, ds, dv)}


def _judge(worst: Dict[str, float], maps, ref_maps, bf16_maps, det, layers,
           net, src_hw, serving, band) -> None:
    """Fold one batch's two parts into ``worst``."""
    worst["head_gap"] = max(worst.get("head_gap", 0.0),
                            head_gap(maps, ref_maps, bf16_maps))
    post = detect.compare(det, maps_served(maps, layers, net, src_hw,
                                           serving), serving, band)
    for k, v in post.items():
        name = "post_gap" if k == "det_gap" else f"post_{k}"
        worst[name] = max(worst.get(name, 0.0), v)


def run(cell, config, traffic, seed, seconds, trace, t0, device):
    path = inputs.cfg_path(config)
    net, layers = refcfg.read(path)
    batch, src_hw = traffic["batch"], (traffic["src_h"], traffic["src_w"])
    pool = inputs.frame_pool(traffic["pool"], *src_hw, seed, device)
    raw = seeded_params(net, layers, seed, device, pool)
    raw_host = {k: {n: v.cpu() for n, v in p.items()}
                for k, p in raw.items()}
    if device == "cuda":
        # the peak from here on is the program's: its inputs, set-up,
        # warm-up and window
        torch.cuda.reset_peak_memory_stats()
    serving = cell["serving"]
    recipe = cell.get("recipe")
    _, params, step = serving_step(cell, path, raw, src_hw, device)
    del raw
    loop = _MapsLoop(step, params, pool, traffic, seed + 2, device)
    try:
        for _ in range(traffic["warmup_batches"]):
            loop.dispatch(spans=False)
        loop.drain()
        sync(device)
        setup_s = time.monotonic() - t0
        loop.enqueue_s.clear()

        sample, k, n_counted = [], traffic["check_batches"], 0
        picker = random.Random(seed + 3)
        dispatched = 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            got = loop.dispatch(spans=False)
            dispatched += 1
            if got is None or time.perf_counter() > t_end:
                continue
            n_counted += 1
            if len(sample) < k:
                sample.append(got)
            else:
                j = picker.randrange(n_counted)
                if j < k:
                    sample[j] = got
        loop.drain()
        sync(device)
        enqueue_s = list(loop.enqueue_s)
        stage_ms = loop.stage_ms(t_start, t_end)

        summary = counted = None
        if trace:
            def traced_steps():
                for _ in range(traffic["trace_batches"]):
                    loop.dispatch(spans=True)
                with tracing.span("sync"):
                    loop.drain()
                    sync(device)
            summary, counted = _traced(traced_steps)
    finally:
        # the producer thread ends and is waited for
        loop.close()
    peak = (torch.cuda.max_memory_allocated()
            if device == "cuda" else 0)
    del step, params, loop
    if device == "cuda":
        torch.cuda.empty_cache()

    check, slim = reference_check(net, layers, raw_host, recipe, serving,
                                  cell["match_band"], pool, sample, src_hw,
                                  device)
    first_conv = next(l for l in slim if l["type"] == "conv")
    rate = n_counted * batch / seconds
    return {
        "metrics": {"serve_img_per_s": rate, "setup_s": setup_s},
        "attempted": dispatched * batch, "failed": 0,
        "memory_peak_bytes": int(peak), "trace": summary,
        "forward_launches": counted,
        "check": check, "limits": cell["check"],
        "driver": "stream", "rate": rate,
        "flops_per_img": arith.conv_flops(slim),
        "spans": {"step_enqueue_s": enqueue_s},
        "shapes": {"batch": batch, "net_h": int(net["height"]),
                   "net_w": int(net["width"]),
                   "conv1_filters": first_conv["filters"]},
        "notes": {"batches_counted": n_counted,
                  "batches_compared": len(sample),
                  **{k: v for k, v in check.items()
                     if k.startswith("post_") and k != "post_gap"},
                  **stage_ms},
    }


def reference_check(net, layers, raw_host, recipe, serving, band, pool,
                    sample, src_hw, device):
    """The two parts' worst over the sampled batches (none without a
    sample), and the reference's own slimmed layers."""
    model.strict_fp32()
    raw = {k: {n: v.to(device) for n, v in p.items()}
           for k, p in raw_host.items()}
    ref_layers, params = prune.apply_recipe(raw, net, layers, recipe)
    folded = model.fold(params, ref_layers)
    worst: Dict[str, float] = {}
    for idx, outs, maps in sample:
        frames = torch.as_tensor(pool[idx], device=device)
        ref_maps, bf16_maps = (reference_maps(folded, net, ref_layers,
                                              frames, lowp)
                               for lowp in (None, "bf16"))
        _judge(worst, [m.permute(0, 3, 1, 2) for m in maps], ref_maps,
               bf16_maps, outs, ref_layers, net, src_hw, serving, band)
    return worst, ref_layers


def checked_draws(cell, config, traffic, seed, device, plant=None):
    """The check of the port's step on the traffic's first
    ``check_batches`` draws, outside any timed window (``plant`` as in
    ``serving_step``): the numbers ``run`` reports under ``check``."""
    from modelcompression_tpu_torch.cli.common import fetch_batch
    path = inputs.cfg_path(config)
    net, layers = refcfg.read(path)
    batch, src_hw = traffic["batch"], (traffic["src_h"], traffic["src_w"])
    pool = inputs.frame_pool(traffic["pool"], *src_hw, seed, device)
    raw = seeded_params(net, layers, seed, device, pool)
    raw_host = {k: {n: v.clone() for n, v in p.items()}
                for k, p in raw.items()}
    _, params, step = serving_step(cell, path, raw, src_hw, device, plant)
    draws = inputs.batch_draws(seed + 2, traffic["pool"], batch)
    sizes = (torch.full((batch,), float(src_hw[1])),
             torch.full((batch,), float(src_hw[0])))
    sample = []
    for _ in range(traffic["check_batches"]):
        idx = next(draws)
        outs = step(params, pool[idx], *sizes)
        sample.append((idx, fetch_batch(outs[:3]), outs[5:]))
    return reference_check(net, layers, raw_host, cell.get("recipe"),
                           cell["serving"], cell["match_band"], pool,
                           sample, src_hw, device)[0]


def control(cell, config, traffic, seed, device):
    """The control: the reference in float8 put in the program's place
    (its head maps, and its own decode and NMS of them as the served
    detections), on the first ``check_batches`` draws of the cell's
    traffic, judged by the same numbers. Returns the worst of each."""
    path = inputs.cfg_path(config)
    net, layers = refcfg.read(path)
    batch, src_hw = traffic["batch"], (traffic["src_h"], traffic["src_w"])
    pool = inputs.frame_pool(traffic["pool"], *src_hw, seed, device)
    raw = seeded_params(net, layers, seed, device, pool)
    model.strict_fp32()
    ref_layers, params = prune.apply_recipe(raw, net, layers,
                                            cell.get("recipe"))
    folded = model.fold(params, ref_layers)
    serving = cell["serving"]
    draws = inputs.batch_draws(seed + 2, traffic["pool"], batch)
    worst: Dict[str, float] = {}
    for _ in range(traffic["check_batches"]):
        frames = torch.as_tensor(pool[next(draws)], device=device)
        ref_maps, bf16_maps, low_maps = (
            reference_maps(folded, net, ref_layers, frames, lowp)
            for lowp in (None, "bf16", "fp8"))
        low = maps_served(low_maps, ref_layers, net, src_hw, serving)
        _judge(worst, low_maps, ref_maps, bf16_maps, low["det"], ref_layers,
               net, src_hw, serving, cell["match_band"])
    return worst
