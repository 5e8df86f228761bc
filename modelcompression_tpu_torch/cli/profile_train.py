"""Where does the train step's time go?

    python -m modelcompression_tpu_torch.cli.profile_train [--unpruned]
        [--batch 64] [--jitter] [--hsv] [--mosaic] [--freeze N]
        [--inner 10] [--stages aug,fwd,loss,bwd,full] [--trace DIR]
        [--device cuda|cpu]

Times cumulative stages of the fine-tune step on YOLOv2-VOC (random init,
seed 0): normalize + augment (``aug``), + the training forward with
batch-statistic BN (``fwd``), + the region loss (``loss``), + the backward
(``bwd``), and the full step (``full``: the SGD update, mask re-apply and
the BN running-statistic fold as well), each with ``utils.timing.time_fn``
(CUDA events on the card; the minimum over 3 windows of ``--inner``
calls). Default: the 75%-filter-pruned repacked model, flip on, jitter 0,
subdivisions 1, batch 64; ``--unpruned`` for the dense model;
``--jitter`` / ``--hsv`` / ``--mosaic`` switch the augment chain on to
price it.

``--trace DIR`` also records 10 full steps with ``torch.profiler`` (a
Chrome trace, ``DIR/trace.json``) and prints the top device operations by
total time. The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

TRACE_STEPS = 10


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--unpruned", action="store_true")
    p.add_argument("--jitter", action="store_true",
                   help="augment with the cfg's crop jitter (0.3)")
    p.add_argument("--hsv", action="store_true")
    p.add_argument("--mosaic", action="store_true")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--freeze", type=int, default=0,
                   help="TrainConfig.freeze_prefix: freeze the first N "
                        "convs (prices the frozen-backbone fine-tune)")
    p.add_argument("--inner", type=int, default=10,
                   help="calls per timed window")
    p.add_argument("--trace", default=None,
                   help="record a torch.profiler trace of the step into "
                        "this dir and print the top device ops")
    p.add_argument("--stages", default="aug,fwd,loss,bwd,full",
                   help="comma list of the stages to time")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def top_ops(prof, device, n=25):
    """[(name, total us, calls)] of the profiler's operations, most time
    first: device kernels and copies on a card, CPU operators (self time)
    on the CPU."""
    from torch.autograd import DeviceType
    if device.type == "cuda":
        rows = [(e.key, e.device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.device_time_total > 0]
    else:
        rows = [(e.key, e.self_cpu_time_total, e.count)
                for e in prof.key_averages() if e.self_cpu_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])[:n]


def main(argv=None) -> int:
    args = parse_args(argv)
    from modelcompression_tpu_torch.compress import (
        repack, uniform_filter_fraction_keep_sets,
    )
    from modelcompression_tpu_torch.core.device import resolve_device
    from modelcompression_tpu_torch.data.preprocess import (
        distort_hsv, random_flip,
    )
    from modelcompression_tpu_torch.models import (
        conv_key, init_params, num_conv_flops, params_to, yolov2_voc,
    )
    from modelcompression_tpu_torch.train import (
        TrainConfig, TrainState, augment_batch, detection_loss,
        make_optimizer, make_train_step,
    )
    from modelcompression_tpu_torch.train.train_step import (
        _forward_train, _trainable_list,
    )
    from modelcompression_tpu_torch.utils.perf_ledger import device_tag
    from modelcompression_tpu_torch.utils.timing import time_fn

    device = resolve_device(args.device)
    print(device_tag() if device.type == "cuda" else "cpu", flush=True)
    B = args.batch
    spec = yolov2_voc()
    params = params_to(init_params(spec, seed=0), device)
    if args.unpruned:
        sspec, sparams = spec, params
    else:
        keep = uniform_filter_fraction_keep_sets(spec, params, 0.75)
        sspec, sparams = repack(spec, params, keep)
    # the fine-tune measurement config (flip on, jitter 0, subdivisions 1)
    tcfg = TrainConfig.from_spec(
        sspec, augment_flip=True, subdivisions=1, max_boxes=30,
        augment_jitter=(0.3 if args.jitter else 0.0),
        augment_hsv=args.hsv, augment_mosaic=args.mosaic,
        freeze_prefix=args.freeze)
    net_h, net_w = sspec.net.height, sspec.net.width
    rng = np.random.default_rng(0)
    images = torch.as_tensor(
        rng.integers(0, 255, (B, net_h, net_w, 3), np.uint8), device=device)
    tg = np.zeros((B, 30, 5), np.float32)
    tg[:, 0] = [0, 0.5, 0.5, 0.3, 0.3]
    targets = torch.as_tensor(tg, device=device)
    gen = torch.Generator().manual_seed(7)
    # the stages' params: trainable tensors with requires_grad, as the
    # step holds them; no stage before "full" updates them
    holder = TrainState.create(sparams, make_optimizer(tcfg), gen)
    stage_params = holder["params"]
    trainable = _trainable_list(stage_params)
    fkeys = frozenset(conv_key(i)
                      for i in sspec.conv_indices()[:args.freeze])
    print(f"batch {B} | inner {args.inner} | "
          f"{'unpruned' if args.unpruned else 'pruned75'} | "
          f"aug flip={tcfg.augment_flip} jitter={tcfg.augment_jitter} "
          f"hsv={tcfg.augment_hsv} mosaic={tcfg.augment_mosaic} | "
          f"{device}", file=sys.stderr)

    def norm_aug():
        """The step's input normalize + augment chain, including its
        uint8-flip fast path when it applies."""
        if (tcfg.augment_flip and tcfg.augment_jitter == 0
                and not tcfg.augment_mosaic):
            xf, t = random_flip(images, targets, gen)
            x = xf.float() / 255.0
            if tcfg.augment_hsv:
                x = distort_hsv(x, gen, hue=tcfg.hue, sat=tcfg.saturation,
                                expo=tcfg.exposure)
            return x, t
        return augment_batch(tcfg, images.float() / 255.0, targets, gen)

    def fwd():
        x, t = norm_aug()
        raw, _ = _forward_train(stage_params, x, sspec, tcfg.precision, {},
                                freeze=fkeys)
        return raw, t

    def loss():
        raw, t = fwd()
        return detection_loss(raw, t, sspec, 0).loss

    def bwd():
        for v in trainable:
            v.grad = None
        loss().backward()

    step = make_train_step(sspec, tcfg)
    state = TrainState.create(sparams, make_optimizer(tcfg),
                              torch.Generator().manual_seed(1))
    programs = {"aug": norm_aug, "fwd": fwd, "loss": loss, "bwd": bwd,
                "full": lambda: step(state, images, targets)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    gf = num_conv_flops(sspec) / 1e9
    results = {}
    for name in [s.strip() for s in args.stages.split(",") if s.strip()]:
        if name not in programs:
            print(f"error: unknown stage {name!r} (one of "
                  f"{', '.join(programs)})", file=sys.stderr)
            return 2
        fn = programs[name]
        t0 = time.perf_counter()
        fn()
        sync()
        first_s = time.perf_counter() - t0
        sec = time_fn(fn, iters=args.inner, windows=3, device=device)
        results[name] = sec
        print(f"{name:5s}: {sec * 1e3:7.2f} ms/step  "
              f"({B / sec:7.1f} img/s; first call {first_s:.1f}s)",
              flush=True)

    if {"fwd", "loss"} <= results.keys():
        print(f"  region loss alone: "
              f"{(results['loss'] - results['fwd']) * 1e3:6.2f} ms")
    if {"loss", "bwd"} <= results.keys():
        print(f"  backward alone:    "
              f"{(results['bwd'] - results['loss']) * 1e3:6.2f} ms")
    if {"bwd", "full"} <= results.keys():
        print(f"  update/fold/misc:  "
              f"{(results['full'] - results['bwd']) * 1e3:6.2f} ms")
    if "full" in results:
        # fwd+bwd ~= 3x fwd FLOPs (dL/dw + dL/dx per conv)
        tf = 3 * gf * B / results["full"] / 1e3
        print(f"  full step: {gf:.2f} GF/img fwd -> ~{tf:.1f} "
              f"effective TFLOPS (fwd+bwd as 3x fwd)")

    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(TRACE_STEPS):
                step(state, images, targets)
            sync()
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))
        what = "device" if device.type == "cuda" else "cpu (self)"
        print(f"trace written to {args.trace}; top {what} ops:")
        print(f"{'op':<40s} {'us/step':>9s} {'calls':>6s}")
        for name, tot, cnt in top_ops(prof, device):
            print(f"{name:<40.40s} {tot / TRACE_STEPS:>9.0f} {cnt:>6d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
