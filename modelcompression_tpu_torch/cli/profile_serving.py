"""Where the serving step's time goes on the card.

    python -m modelcompression_tpu_torch.cli.profile_serving

For YOLOv2-VOC 416 (random init, seed 0), unpruned and 75%-filter-pruned
and repacked, FAST precision, the deployment config, batch 64 of 384x512
frames letterboxed on the device. Prints one JSON line per model:

* ``ab_ms``: the whole step with the fused input-stage kernel and with
  cuDNN conv + leaky + pool instead (``fuse_input_stage=False``), timed in
  turns (fused, unfused, unfused, fused, twice) with CUDA events;
* ``stages_ms``: letterbox, forward, and decode + NMS + pixel mapping,
  each timed alone with CUDA events;
* ``profile``: a ``torch.profiler`` window over 3 steady steps: device
  time by kernel (top 12), device operations per step, the device's busy
  and idle share of the wall time, the input-stage kernel's share of
  device time (the tensor-core kernel on this bf16 path), and for each of
  the step's spans (``serve.step`` and its ``serve.letterbox``,
  ``serve.forward`` and ``serve.postprocess``, the last over
  ``serve.decode`` and ``serve.nms``) its host ms and the device idle ms
  under it.

A first line gives the card's name and power limit, a second what a span
costs the host (``span_cost_us``): with no profiler, and under one.

Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from modelcompression_tpu_torch.cli._profiling import (
    profile_window, time_ms,
)

BATCH, SRC_H, SRC_W, NET = 64, 384, 512, 416
# device kernel name of the FAST (bf16) path's input stage, the only one
# these FAST steps launch
INPUT_STAGE_KERNELS = ("conv1_pool_mma_kernel",)


def _profile(fn):
    """The shared profiler window plus the input-stage kernel's share of
    the device time."""
    summary, rows = profile_window(fn)
    busy_us = sum(r[1] for r in rows)
    stage = sum(r[1] for r in rows if any(
        name in r[0] for name in INPUT_STAGE_KERNELS))
    summary["input_stage_share_of_device"] = \
        stage / busy_us if busy_us else 0.0
    return summary


def span_cost_us(n=100_000):
    """Host microseconds one ``utils.profiling.span`` adds, entered and
    left in a loop, against the same loop without it: ``off`` over ``n``
    with no profiler, ``on`` over ``n // 10`` under a CPU and CUDA
    profiler (the ``record_function`` range and the log record)."""
    from torch.profiler import ProfilerActivity, profile

    from modelcompression_tpu_torch.utils.profiling import (
        clear_span_log, span,
    )

    def per_loop(count, with_span):
        t = time.perf_counter()
        if with_span:
            for _ in range(count):
                with span("cost"):
                    pass
        else:
            for _ in range(count):
                pass
        return (time.perf_counter() - t) / count * 1e6

    base = per_loop(n, False)
    off = per_loop(n, True) - base
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        on = per_loop(n // 10, True) - base
    clear_span_log()
    return {"off": off, "on": on, "n_off": n, "n_on": n // 10}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 1
    from modelcompression_tpu_torch.compress import (
        repack, uniform_filter_fraction_keep_sets,
    )
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.data.preprocess import letterbox_device
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, batched_per_class_nms_prefiltered, center_to_corners,
        corners_to_image, decode_heads, make_eval_step,
    )
    from modelcompression_tpu_torch.models import (
        fold_batchnorm, forward_folded, init_params, params_to, yolov2_voc,
    )
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"span_cost_us": span_cost_us()}), flush=True)
    spec = yolov2_voc()
    params = init_params(spec, seed=0)
    keep = uniform_filter_fraction_keep_sets(spec, params, 0.75)
    pspec, pparams = repack(spec, params, keep)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randint(0, 256, (BATCH, SRC_H, SRC_W, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    img_w = torch.full((BATCH,), float(SRC_W), device="cuda")
    img_h = torch.full((BATCH,), float(SRC_H), device="cuda")
    for label, s, p in (("unpruned", spec, params),
                        ("pruned75", pspec, pparams)):
        folded = params_to(fold_batchnorm(p, s), "cuda")
        steps = {}
        for fuse in (True, False):
            cfg = EvalConfig(conf_thresh=0.01, max_detections=32,
                             nms_prefilter=128, precision=FAST,
                             fuse_input_stage=fuse, device="cuda")
            step = make_eval_step(s, cfg, src_hw=(SRC_H, SRC_W))
            steps[fuse] = (lambda st=step: st(folded, images, img_w, img_h))
        ab = {"fused": [], "unfused": []}
        for fuse in (True, False, False, True) * 2:
            ab["fused" if fuse else "unfused"].append(time_ms(steps[fuse]))
        with torch.inference_mode():
            x = letterbox_device(images, NET, NET, dtype=torch.bfloat16)
            raw = forward_folded(folded, x, s, FAST, fuse_input_stage=True)

            def post():
                boxes, obj, cls = decode_heads(raw, s)
                sel, sc, valid = batched_per_class_nms_prefiltered(
                    center_to_corners(boxes), obj[..., None] * cls, 0.45,
                    0.01, 32, prefilter=128)
                return corners_to_image(sel, img_w[:, None, None],
                                        img_h[:, None, None], NET, NET,
                                        True), sc, valid
            stages = {
                "letterbox": time_ms(lambda: letterbox_device(
                    images, NET, NET, dtype=torch.bfloat16)),
                "forward": time_ms(lambda: forward_folded(
                    folded, x, s, FAST, fuse_input_stage=True)),
                "post": time_ms(post),
            }
        print(json.dumps({"model": label, "card": card,
                          "conv1_filters": s.layers[0].filters,
                          "ab_ms": ab, "stages_ms": stages,
                          "profile": _profile(steps[True])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
