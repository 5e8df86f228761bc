"""Drive the PyTorch port's serving, magnitude-prune, evaluation,
fine-tune and YOLOv3 / YOLOv4 serving paths on one NVIDIA GPU and check
them.

    python3 chip_smoke.py

Phases, each printing JSON lines on stdout:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    compile every kernel of the port from ``csrc/`` (one nvcc per
            source, all started together), timed, with ptxas's registers
            and spills per kernel and, for the fp32 input stage, its SASS
            instruction mix (cuobjdump).
3. kernels  each kernel against its plain PyTorch version at the main
            paths' shapes, with kernel, plain and library times from CUDA
            events and the roofline bound. Input stage: B=64, 416x416, C in
            {32, 8}, bf16 and fp32, tolerance stated per case; bf16 runs
            the tensor-core (mma) kernel, fp32 the fp32 CUDA-core kernel,
            each timed beside the first CUDA-core kernel (``input_stage``,
            the yardstick no path launches) in the same dtype (``prev_ms``,
            ``prev_max_abs_err``). Top-k/mask
            (radix select, tie count, apply, and the count kernel, the
            yardstick no path launches): the flat layout of YOLOv2-VOC's 23
            convs (50,634,592 weights, padded), per-layer (S=24) and global
            (S=2), on the random weights, on bf16-valued weights (ties), and
            re-pruning pruned weights (0.5 then 0.75; 0.75 then 0.5, where
            the threshold is 0.0): the select's kth and n_below equal its
            plain version's and the bisection's, counts equal, outputs
            bit-equal. The select is timed whole and per launch beside the
            31-round bisection through the count kernel; tie count and
            apply at the chunk prune_flat sizes to the input and at 16K.
4. main     YOLOv2-VOC 416 (random init, seed 0), FAST precision, the
            deployment config (conf 0.01, K 32, prefilter 128), the fused
            serving step with on-device letterbox from 384x512 frames at
            batch 64: unpruned, then 75%-filter-pruned and repacked. Each
            run starts with every kernel launch count at 0 and fails unless
            each kernel of the path launched (the mma input stage, never
            a CUDA-core one); outputs must be finite with the stated
            shapes, and a small fp32 (BITMATCH) batch must agree with the
            same forward on the CPU (through the fp32 input-stage kernel,
            never the mma or the yardstick). Steady img/s from CUDA
            events.
5. server   the serve CLI's build_server on 127.0.0.1 (--deployment
            --batch 64 --device cuda, random weights): /healthz, a few
            canvases through the dispatcher queue, two PNG frames posted
            to /detect, /stats, shutdown.
6. prune    the prune CLI on full-width YOLOv2-VOC (random weights from seed
            0 written as .weights), --mode magnitude then --mode global at
            --sparsity 0.75 --device cuda. Each call must launch the radix
            select exactly 5 times, the tie-count and apply kernels once,
            and the count kernel never; the written masks must equal the
            reference (stable argsort) backend's on the card, with exactly
            floor(0.75 n) zeros per layer (global: of all N). The written
            .weights are reloaded and served at batch 64 as in phase 4,
            through the mma input-stage kernel.
7. eval     with ``import cv2`` made to fail for the whole phase: a
            160-image VOC fixture (VOC's 20 class names, 416x416 PNGs from
            the port's own writer, so neither decode nor letterbox needs
            cv2: two full batches of 64 and a ragged one of 32). The
            eval CLI on full-width YOLOv2-VOC (phase 6's random .weights)
            at --batch 64 --device cuda, FAST: exit 0, a summary, the mma
            input stage launched once per batch (3) and the CUDA-core ones
            never. ``evaluate``'s first-batch detections must equal the
            eval step's on the same 64 canvases. Then --precision bitmatch
            on the first 64 images (no input-stage launch), --recall (exit
            0), and prune --mode magnitude --sweep 0.5,0.75 --data at
            --batch 64 (radix select / count / tie-count / apply launched
            10 / 0 / 2 / 2 times; a finite mAP@50 per point). Reports
            steady eval img/s (host PNG decode included), the mAP (random
            weights: a smoke value, not an accuracy figure), each path's
            launches by kernel width (C, S), and the host decode time of
            one 416x416 image re-encoded with each PNG row filter.
8. finetune with ``import cv2`` still made to fail: full-width YOLOv2-VOC
            (the cfg's batch 64, subdivisions 8, jitter .3, FAST) on phase
            7's fixture as train and eval list. First the train step alone
            on fixed batches: steady ms and img/s at 416 with subdivisions 8
            and 1, and at 320 and 608 (the ends of the multi-scale band the
            train CLI defaults to) with 8 (CUDA events), peak memory, the
            share of the bf16 peak at 3 x the conv FLOPs per image, a
            profiler window (device busy and idle); and, at 416, 320 and
            608, one step at batch 2 on the card and on the CPU from the
            same params, in BITMATCH (loss within 1e-5 relative, the last
            conv's gradient within 1e-4 of its largest magnitude; the
            BN-side gradients, which fp32 gets only to ~1e-1 at random init,
            are reported against float64) and in float64 (loss within 1e-5
            relative, every gradient tensor within 1e-4 of its largest
            magnitude). Then the CLIs: (a) finetune --preserve-sparsity on
            phase 6's magnitude-pruned .weights: finite losses, every zero
            still zero, seen grown by steps x 64, 3 input-stage launches in
            the final eval; (b) --iterate 0.5,0.75 --iterate-mode magnitude:
            radix select / count / tie / apply launched 10 / 0 / 2 / 2 times
            at S=24, each round's masks with floor(s n) zeros per conv and
            its pruned weights zero after the round's steps, mask ms against
            the round's train seconds; (c) --iterate-mode l1_filter: the
            rounds' evals launch the input stage at C=16, then C=8; (e) the
            train CLI killed after 2 steps and resumed to 4
            (--checkpoint-dir, --resume) against an uninterrupted 4-step run
            (cuDNN's deterministic algorithms): step, seen and generator
            equal, params and momentum within 1e-4 of their largest
            magnitude.
9. families YOLOv4-VOC 416 (random init, seed 0; its 20 classes, three
            [yolo] heads, 10,647 candidates an image), unpruned and 75%-
            filter-pruned and repacked, served as in phase 4: (a) no kernel
            launched (conv1 feeds a conv, so no input stage), ms/batch,
            img/s, peak memory, a profiler window, the fp32 raw maps of one
            frame card vs CPU within 1e-4 max rel per head; (b) the same
            step with the bisect prefilter: radix select / count / tie-count
            / apply launched exactly 5 / 0 / 1 / 1 times at S=64, its
            keep-set equal to the plain route's on the same scores, timed;
            the top-k kernels against their plain versions at this shape,
            timed as in phase 3 (torch.topk of the 128 best per image beside
            the select); (c) at this NMS shape (B=64, N=10,647, C=20, K=32)
            the default, DIoU (beta 0.6), bisect, nms_padded and soft-NMS
            (Gaussian, linear) on the card against the CPU on the same
            candidates: selections equal (soft-NMS scores within 1e-6
            relative), each timed. The serve CLI's server on yolov4-voc.cfg
            as in phase 5, with --diou-nms --diou-beta 0.6
            --nms-prefilter-impl bisect: exactly 5 / 0 / 1 / 1 launches for
            every batch it served. (d) YOLOv3-tiny 416 (80 classes) at batch
            64: exactly 1 tensor-core input-stage launch at C=16 a batch,
            and the fp32 card-vs-CPU forward through the fp32 input stage.
            (e) detect --dir on 8 fixture images and eval --diou-nms
            --nms-prefilter 128 --nms-prefilter-impl bisect on phase 7's
            fixture (5 / 0 / 1 / 1 launches a batch), both on random-weight
            YOLOv4-tiny-VOC 416, and summary of yolov4.cfg (608): each exits
            0.

Then a ``{"kernels": [...]}`` line and, last, the device line. Any failure
exits non-zero without the last line; so does a machine without CUDA or a
directory without the port's package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

BATCH = 64
SRC_H, SRC_W = 384, 512
NET = 416
PRUNE_FRACTION = 0.75
SPARSITY = 0.75
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W); the
# top-k kernels' integer compares and adds are counted against the CUDA
# cores' float32 rate, the data sheet's nearest figure for 32-bit ALU work
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
SERVING_KERNELS = ("input_stage_mma",)
# the fp32 (BITMATCH) route's input stage, never launched while serving
FP32_INPUT_STAGE = "input_stage_f32"
# the first CUDA-core input stage: timed as both routes' yardstick, never
# launched by a path
YARDSTICK = "input_stage"
# launches of one magnitude prune: the radix select's 4 histogram passes
# and its select launch, then the tie count and the apply; the count
# kernel (the bisection's yardstick) never
PRUNE_LAUNCHES = {"topk_radix_select": 5, "topk_tie_counts": 1,
                  "topk_apply": 1}
SELECT_LAUNCHES = PRUNE_LAUNCHES["topk_radix_select"]
# the count kernel: the PR 2 bisection's, timed as the radix select's
# yardstick and never launched by a path
TOPK_YARDSTICK = "topk_count_le"
# the eval fixture: two full batches and a ragged one
EVAL_IMAGES = 160
SWEEP_POINTS = (0.5, 0.75)


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up
    and a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": n_ops}


def reset_counts(kernels) -> None:
    for _, wrapper in kernels:
        wrapper.LAUNCHES = 0
        wrapper.LAUNCHES_AT.clear()


def read_counts(kernels) -> dict:
    return {name: wrapper.LAUNCHES for name, wrapper in kernels}


def read_widths(kernels) -> dict:
    """Each kernel's launches by its width: C for the input stages, S for
    the top-k kernels (the wrappers' ``LAUNCHES_AT``)."""
    return {name: dict(wrapper.LAUNCHES_AT) for name, wrapper in kernels}


def sass_mix(path: str) -> dict:
    """Per kernel function of a built library (cuobjdump -sass): the
    instruction count, the FFMA count, and FFMA's share of all
    instructions and of the span from the first FFMA to the last (the
    unrolled compute; the halo copies and setup lie outside it). NOPs are
    not counted."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    funcs, ops = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            ops = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and ops is not None and not m.group(1).startswith("NOP"):
            ops.append(m.group(1).split(".")[0])
    out = {}
    for name, seq in funcs.items():
        ffma = [i for i, op in enumerate(seq) if op == "FFMA"]
        if not ffma:
            continue
        span = ffma[-1] - ffma[0] + 1
        out[name] = {"instructions": len(seq), "ffma": len(ffma),
                     "ffma_share": len(ffma) / len(seq),
                     "compute_span": span,
                     "ffma_share_of_span": len(ffma) / span}
    return out


def phase_build(kernels):
    from modelcompression_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all(name for name, _ in kernels)
    seconds = time.perf_counter() - t0
    for name, _ in kernels:  # load now, so no later phase pays for it
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.BUILD_LOG.items()}
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "libraries": {n: os.path.relpath(p) for n, p in paths.items()},
          "ptxas": ptxas,
          "sass_mix": {FP32_INPUT_STAGE: sass_mix(paths[FP32_INPUT_STAGE])}})


def input_stage_case(torch, c_out: int, dtype, gen):
    """Kernel vs plain version at the main path's input-stage shape: bf16
    on the tensor-core kernel, fp32 on the fp32 CUDA-core kernel, each
    with the yardstick kernel's time and error in the same dtype beside
    it (``prev_ms``, ``prev_max_abs_err``)."""
    import torch.nn.functional as F
    from modelcompression_tpu_torch.ops import input_stage as tis
    dev = torch.device("cuda")
    x = torch.rand((BATCH, NET, NET, 3), generator=gen, device=dev) \
        .to(dtype)
    w = (torch.randn((c_out, 3, 3, 3), generator=gen, device=dev) * 0.2) \
        .to(dtype)
    b = torch.randn((c_out,), generator=gen, device=dev) * 0.5
    bf16 = dtype == torch.bfloat16

    def kernel():
        if bf16:
            return tis.fused_conv1_pool_mma(x, w, b)
        return tis.fused_conv1_pool_f32(x, w, b)

    def prev():
        return tis.fused_conv1_pool_cuda(x, w, b, dtype)

    got = kernel()
    want = tis.fused_conv1_pool_plain(x, w, b, dtype)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (BATCH, NET // 2, NET // 2, c_out),
          f"input_stage shape {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    # fp32: summation order only; bf16: one ulp of the final rounding
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
    check(err <= tol, f"input_stage C={c_out} {dtype}: max abs err {err} "
          f"> tolerance {tol}")
    prev_err = (prev().float() - want.float()).abs().max().item()
    check(prev_err <= tol, f"yardstick input_stage C={c_out} {dtype}: max "
          f"abs err {prev_err} > tolerance {tol}")
    extra = {"prev_max_abs_err": prev_err,
             "prev_ms": time_ms(torch, prev, iters=20)}

    x_nchw = x.permute(0, 3, 1, 2)  # channels-last storage
    w_cl = w.contiguous(memory_format=torch.channels_last)
    b_lib = b.to(dtype)

    def library():
        return F.max_pool2d(F.leaky_relu(F.conv2d(x_nchw, w_cl, b_lib,
                                                  padding=1), 0.1), 2)

    ms = time_ms(torch, kernel, iters=20)
    plain_ms = time_ms(torch, lambda: tis.fused_conv1_pool_plain(
        x, w, b, dtype), iters=5)
    library_ms = time_ms(torch, library, iters=20)
    elt = x.element_size()
    n_bytes = (x.numel() + w.numel() + got.numel()) * elt + b.numel() * 4
    n_ops = 2 * 27 * c_out * BATCH * NET * NET  # 4 phases x 27 taps x C
    name = str(dtype).split(".")[1]
    return {"c_out": c_out, "dtype": name,
            "kernel": "input_stage_mma" if bf16 else FP32_INPUT_STAGE,
            "max_abs_err": err, "tolerance": tol, "ms": ms, **extra,
            "plain_ms": plain_ms, "library_ms": library_ms,
            **bound(n_bytes, n_ops, PEAK_OPS_PER_S[name])}


def phase_kernels(torch):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.backends.cudnn.allow_tf32 = False  # fp32 cases: no TF32 yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    # C=32 / C=8: YOLOv2-VOC unpruned / 75%-pruned; C=16: YOLOv3-tiny
    for c_out in (32, 8, 16):
        for dtype in (torch.bfloat16, torch.float32):
            r = input_stage_case(torch, c_out, dtype, gen)
            cases[(c_out, r["dtype"])] = r
            emit({"phase": "kernels", "ok": True, **r})
    return cases


TOPK_VARIANTS = ("random", "ties", "reprune_50_75", "reprune_75_50")


def _topk_layout(torch, spec, params, per_layer, variant):
    """The flat prune inputs of one case (the port's layout of the convs)
    and its sparsity: the random weights; bf16-valued weights stored as
    fp32 (ties at the threshold); or weights pruned once by the reference
    rule and pruned again, at 0.75 after 0.5 or at 0.5 after 0.75 (where
    the threshold is 0.0 and the zeros are the ties)."""
    from modelcompression_tpu_torch.compress import apply_masks, criteria
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    sparsity = SPARSITY
    if variant == "ties":
        params = {k: dict(p, w=p["w"].to(torch.bfloat16).float())
                  for k, p in params.items()}
    elif variant != "random":
        first, sparsity = {"reprune_50_75": (0.5, 0.75),
                           "reprune_75_50": (0.75, 0.5)}[variant]
        masks_fn = criteria.magnitude_masks_perlayer if per_layer \
            else criteria.magnitude_masks_global
        params = apply_masks(params, masks_fn(params, spec, first))
    return ct._prune_layout(params, spec, sparsity, per_layer, ())


def radix_pass_ms(torch, bits, seg, k, S, iters=10):
    """Each of the radix select's 5 launches timed alone with CUDA events
    (the wrapper's loop, outside its launch count), mean ms over
    ``iters`` selects after one warm-up: the four histogram passes, then
    the select launch."""
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    kk = k.to(torch.int64).contiguous()
    n_launch = len(ct.RADIX_SHIFTS) + 1
    total = [0.0] * n_launch
    for it in range(iters + 1):
        hist = torch.zeros((len(ct.RADIX_SHIFTS), S, ct.RADIX_BINS),
                           dtype=torch.int32, device=bits.device)
        kth = torch.empty(S, dtype=torch.int64, device=bits.device)
        below = torch.empty_like(kth)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(n_launch + 1)]
        ev[0].record()
        for p in range(n_launch):
            ct._launch("topk_radix_select", (bits, seg, kk, hist, kth, below),
                       bits.numel(), S, p)
            ev[p + 1].record()
        ev[-1].synchronize()
        if it:  # the first select warms up
            for p in range(n_launch):
                total[p] += ev[p].elapsed_time(ev[p + 1])
    return [t / iters for t in total]


def device_ms(fn, calls=10) -> float:
    """Device time per call of ``fn``: its kernels' device time summed
    over a torch.profiler window of ``calls`` calls, ms. Where launches
    are shorter than the host's time to issue them, CUDA events around a
    run of calls measure the host; this does not."""
    from modelcompression_tpu_torch.cli._profiling import profile_window
    return profile_window(fn, steps=calls)[0]["device_busy_ms_per_step"]


def topk_case(torch, layout, variant, kth_library=False, pad_segment=True,
              library=None, device_times=False):
    """The top-k/mask kernels against their plain versions on the inputs
    a prune of this flat ``layout`` (``_prune_layout``'s tuple) feeds
    them, then timed: outputs equal (every output is a count, a bit
    pattern or a copy of an input). The radix select's kth and n_below
    equal its plain version's and the bisection's rule; the count kernel
    (the yardstick) equals its plain version at the bisection's pivots;
    the tie-count and apply kernels run at the chunk ``prune_flat`` sizes
    to the input (``ct.grid_chunk``), and are timed at 16K as well
    (``chunk16k_ms``, PR 2's grid). The select is timed whole
    (``select_ms``) and per launch (``pass_ms``) beside the 31-round
    bisection through the count kernel (``prev_ms``). ``kth_library``:
    time torch.kthvalue for the single real segment's k-th |w|;
    ``library``: another PyTorch call for the whole selection, timed
    instead; ``pad_segment``: the last segment is the padding;
    ``device_times``: each kernel's device time as well (``device_ms``,
    ``chunk16k_device_ms``), for launches shorter than their host cost."""
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    from modelcompression_tpu_torch.ops import topk_mask as tm
    keys, cat, sizes, seg, n_zero, S = layout
    n = cat.numel()
    bits = tm.abs_bits(cat)
    k = (n_zero - 1).clamp_min(0)
    kth = tm.segmented_kth_bits(bits, seg, k, S)
    tau = torch.where(n_zero > 0, kth, 0)
    below = torch.where(tau > 0, tau - 1, 0)
    n_below = torch.where((n_zero > 0) & (tau > 0),
                          ct.count_le_plain(bits, seg, below, S), 0)
    budget = torch.where(n_zero > 0, n_zero - n_below, 0)
    chunk = ct.grid_chunk(n, cat.device)
    per_chunk = ct.tie_counts_plain(bits, seg, tau, S, chunk)
    pc = per_chunk.long()
    chunk_off = torch.cumsum(pc.sum(1), 0) - pc.sum(1)
    seg_start = torch.cumsum(pc.sum(0), 0) - pc.sum(0)
    ones = torch.ones_like(cat)
    rest = (bits, seg, tau, budget, seg_start, chunk_off)
    label = f"top-k S={S} {variant}"
    err = {"radix_select": 0.0, "count_le": 0.0, "tie_counts": 0.0,
           "apply": 0.0}

    def compare(key, got, want, what):
        err[key] = max(err[key], (got.double() - want.double()).abs().max()
                       .item())
        check(torch.equal(got.view(torch.int32) if key == "apply" else got,
                          want.view(torch.int32) if key == "apply" else want),
              f"{label}: {what} differs from its plain version")

    plain_sel = ct.radix_select_plain(bits, seg, k, S)
    check(torch.equal(plain_sel[0], kth), f"{label}: the plain radix select "
          "differs from the bisection")
    check(torch.equal(plain_sel[1],
                      ct.count_le_plain(bits, seg, kth - 1, S)),
          f"{label}: the plain radix select's n_below is not count(< kth)")
    for got, want, what in zip(ct.radix_select_cuda(bits, seg, k, S),
                               plain_sel, ("kth", "n_below")):
        compare("radix_select", got, want, f"radix-select kernel {what}")
    for mid in (kth, below):
        compare("count_le", ct.count_le_cuda(bits, seg, mid, S),
                ct.count_le_plain(bits, seg, mid, S), "count kernel")
    compare("tie_counts", ct.tie_counts_cuda(bits, seg, tau, S, chunk),
            per_chunk, "tie-count kernel")
    outs = []
    for src in (ones, cat):  # the mask (the CLI's path), the weights
        got = ct.apply_threshold_cuda(src, *rest, chunk)
        compare("apply", got, ct.apply_threshold_plain(src, *rest, chunk),
                "apply kernel output (bit for bit)")
        outs.append(got)
    n_pruned = int((outs[0] == 0).sum())
    check(n_pruned == int(n_zero.sum()), f"{label}: the mask prunes "
          f"{n_pruned} weights, the rule {int(n_zero.sum())}")

    def timed(key, kernel, plain, args, n_bytes, n_ops):
        return {"max_abs_err": err[key],
                "ms": time_ms(torch, lambda: kernel(*args), iters=10),
                "plain_ms": time_ms(torch, lambda: plain(*args), iters=2,
                                    warmup=1),
                **bound(n_bytes, n_ops, PEAK_OPS_PER_S["float32"])}

    # the tie table and the apply's chunk offsets at 16K, PR 2's grid
    pc16 = ct.tie_counts_plain(bits, seg, tau, S).long()
    off16 = torch.cumsum(pc16.sum(1), 0) - pc16.sum(1)
    chunks = per_chunk.shape[0]
    real = slice(0, S - 1) if pad_segment else slice(0, S)
    bisection_ms = time_ms(torch, lambda: tm.segmented_kth_bits(
        bits, seg, k, S, count_le=ct.count_le_cuda), iters=3, warmup=1)
    pass_ms = radix_pass_ms(torch, bits, seg, k, S)
    # each input read once (bits, seg: 8 B an element; k: 8 B a segment),
    # each output written once (kth, n_below); one pass reads bits and seg
    select = timed("radix_select", ct.radix_select_cuda,
                   ct.radix_select_plain, (bits, seg, k, S), 8 * n + 24 * S,
                   2 * n)
    select.update({
        "select_ms": select["ms"], "pass_ms": pass_ms,
        "pass_bound_ms": bound(8 * n, 2 * n,
                               PEAK_OPS_PER_S["float32"])["bound_ms"],
        "four_pass_bound_ms": 4 * 8 * n / HBM_BYTES_PER_S * 1e3,
        "prev_ms": bisection_ms})
    r = {"S": S, "variant": variant, "n": n, "weights": sum(sizes),
         "chunk": chunk, "blocks": chunks,
         "segments_at_threshold_zero": int((tau[real] == 0).sum()),
         "ties_at_threshold": int(pc[:, real].sum()),  # padding excluded
         # bytes: each input read once, each output written once
         "radix_select": select,
         "count_le": timed("count_le", ct.count_le_cuda, ct.count_le_plain,
                           (bits, seg, kth, S), 8 * n + 12 * S, 2 * n),
         "tie_counts": dict(
             timed("tie_counts", ct.tie_counts_cuda, ct.tie_counts_plain,
                   (bits, seg, tau, S, chunk),
                   8 * n + 4 * S + 4 * chunks * S, 2 * n),
             chunk16k_ms=time_ms(torch, lambda: ct.tie_counts_cuda(
                 bits, seg, tau, S), iters=10)),
         "apply": dict(
             timed("apply", ct.apply_threshold_cuda,
                   ct.apply_threshold_plain, (ones,) + rest + (chunk,),
                   16 * n + 12 * S + 8 * chunks, 4 * n),
             chunk16k_ms=time_ms(torch, lambda: ct.apply_threshold_cuda(
                 ones, bits, seg, tau, budget, seg_start, off16), iters=10)),
         "bisection_ms": bisection_ms,
         "kthvalue_ms": None}
    if library is not None:
        r["kthvalue_ms"] = time_ms(torch, library, iters=3, warmup=1)
    if kth_library:
        # the one PyTorch call for the select's job: the k-th |w|
        absw = cat[:sum(sizes)].abs()
        kk = int(k[0]) + 1
        kv = torch.kthvalue(absw, kk).values.reshape(1)
        check(int(tm.abs_bits(kv)[0]) == int(kth[0]),
              f"{label}: torch.kthvalue disagrees with the bisection")
        if variant == "random":  # the main path's case; ~0.4 s a call
            r["kthvalue_ms"] = time_ms(
                torch, lambda: torch.kthvalue(absw, kk), iters=3, warmup=1)
    select["library_ms"] = r["kthvalue_ms"]
    if device_times:
        for key, fn in (
                ("radix_select", lambda: ct.radix_select_cuda(bits, seg, k,
                                                              S)),
                ("count_le", lambda: ct.count_le_cuda(bits, seg, kth, S)),
                ("tie_counts", lambda: ct.tie_counts_cuda(bits, seg, tau, S,
                                                          chunk)),
                ("apply", lambda: ct.apply_threshold_cuda(ones, *rest,
                                                          chunk))):
            r[key]["device_ms"] = device_ms(fn)
        if library is not None:
            r["radix_select"]["library_device_ms"] = device_ms(library)
        r["tie_counts"]["chunk16k_device_ms"] = device_ms(
            lambda: ct.tie_counts_cuda(bits, seg, tau, S))
        r["apply"]["chunk16k_device_ms"] = device_ms(
            lambda: ct.apply_threshold_cuda(ones, bits, seg, tau, budget,
                                            seg_start, off16))
    return r


def phase_topk_kernels(torch):
    from modelcompression_tpu_torch.models import (
        init_params, params_to, yolov2_voc,
    )
    spec = yolov2_voc()
    params = params_to(init_params(spec, seed=SEED), "cuda")
    cases = {}
    for per_layer in (True, False):
        for variant in TOPK_VARIANTS:
            r = topk_case(torch, _topk_layout(torch, spec, params,
                                              per_layer, variant),
                          variant, kth_library=not per_layer)
            cases[(r["S"], variant)] = r
            emit({"phase": "kernels", "ok": True, "kernel": "topk", **r})
    return cases


def _models(torch):
    from modelcompression_tpu_torch.compress import (
        repack, uniform_filter_fraction_keep_sets,
    )
    from modelcompression_tpu_torch.models import init_params, yolov2_voc
    spec = yolov2_voc()
    params = init_params(spec, seed=SEED)
    keep = uniform_filter_fraction_keep_sets(spec, params, PRUNE_FRACTION)
    pspec, pparams = repack(spec, params, keep)
    check(pspec.layers[0].filters == 8, "75% repack should leave conv1 "
          f"with 8 filters, got {pspec.layers[0].filters}")
    return [("unpruned", spec, params), ("pruned75", pspec, pparams)]


def _agrees_with_cpu(torch, kernels, spec, params, n_frames=2):
    """The card against the CPU on ``n_frames`` frames, in two halves:

    * letterbox + forward (the fp32 input-stage kernel included, its
      launches counted) in fp32 with TF32 off: the raw maps must agree
      to summation order (max rel 1e-4);
    * NMS + pixel mapping on the same decoded candidates: must be EQUAL
      (IEEE elementwise ops and a stable sort on both devices). The halves
      are split because random weights put every candidate above conf and
      many scores on near-ties, where a last-bit forward difference
      legitimately reorders the top-K.

    The fp32 input-stage kernel must launch when ``input_stage_match``
    holds for the spec, and no input stage otherwise. Multi-head ([yolo])
    specs are held head by head."""
    import numpy as np
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.data.preprocess import letterbox_device
    from modelcompression_tpu_torch.evaluation import (
        batched_per_class_nms_prefiltered, center_to_corners,
        corners_to_image, decode_heads,
    )
    from modelcompression_tpu_torch.models import (
        fold_batchnorm, forward_folded, params_to,
    )
    from modelcompression_tpu_torch.ops import input_stage_match
    frames = np.random.default_rng(SEED).integers(
        0, 256, (n_frames, SRC_H, SRC_W, 3), np.uint8)
    fp32_stage = input_stage_match(spec)  # the fusion's precondition
    folded = fold_batchnorm(params, spec)
    BITMATCH.apply_backend_flags()
    raw = {}
    reset_counts(kernels)
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            x = letterbox_device(torch.as_tensor(frames, device=dev),
                                 NET, NET)
            y = forward_folded(params_to(folded, dev), x, spec, BITMATCH,
                               fuse_input_stage=fp32_stage)
            raw[dev] = [t.cpu() for t in
                        (y if isinstance(y, (tuple, list)) else [y])]
    counts = read_counts(kernels)
    check(counts[FP32_INPUT_STAGE] == int(fp32_stage)
          and counts["input_stage_mma"] == 0 and counts[YARDSTICK] == 0,
          f"fp32 forward: input-stage launches {counts}")
    with torch.inference_mode():
        rels = [((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(raw["cuda"], raw["cpu"])]
        rel = max(rels)
        check(rel <= 1e-4, f"fp32 raw maps card vs CPU: max rel {rels} > "
              "1e-4")
        heads = raw["cpu"] if spec.is_multi_head else raw["cpu"][0]
        boxes, obj, cls = decode_heads(heads, spec)
        scores, corners = obj[..., None] * cls, center_to_corners(boxes)
        wh = torch.full((n_frames, 1), float(SRC_W)), \
            torch.full((n_frames, 1), float(SRC_H))
        post = {}
        for dev in ("cpu", "cuda"):
            sel, sc, valid = batched_per_class_nms_prefiltered(
                corners.to(dev), scores.to(dev), 0.45, 0.01, 32,
                prefilter=128)
            sel = corners_to_image(sel, wh[0].to(dev)[..., None],
                                   wh[1].to(dev)[..., None], NET, NET, True)
            post[dev] = [t.cpu() for t in (sel, sc, valid)]
    for a, b in zip(post["cuda"], post["cpu"]):
        check(torch.equal(a, b), "NMS on the card differs from the CPU on "
              "the same candidates")
    return {"raw_max_rel": rel, "raw_max_rel_by_head": rels,
            "nms_equal": True,
            "valid_detections": int(post["cpu"][2].sum().item()),
            "launches": counts}


def drive_serving(torch, kernels, spec, params, label, want=None,
                  profile=False, **cfg_kw):
    """The fused serving step at batch 64 from 384x512 frames with the
    deployment config (``cfg_kw`` adds EvalConfig options), on the card:
    run once with every launch count at 0 (each kernel of the serving
    path must launch, or with ``want`` exactly those counts; outputs
    finite with the stated shapes), then steady img/s from CUDA events
    and the peak device memory of the timed steps; with ``profile`` a
    profiler window (device operations per step, busy and idle)."""
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models import (
        fold_batchnorm, num_conv_flops, params_to,
    )
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    images = torch.randint(0, 256, (BATCH, SRC_H, SRC_W, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    img_w = torch.full((BATCH,), float(SRC_W), device="cuda")
    img_h = torch.full((BATCH,), float(SRC_H), device="cuda")
    cfg = EvalConfig(**{"conf_thresh": 0.01, "max_detections": 32,
                        "nms_prefilter": 128, "precision": FAST,
                        "device": "cuda", **cfg_kw})
    folded = params_to(fold_batchnorm(params, spec), "cuda")
    step = make_eval_step(spec, cfg, src_hw=(SRC_H, SRC_W))
    reset_counts(kernels)
    outs = step(folded, images, img_w, img_h)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    at = read_widths(kernels)
    if want is not None:
        want = {name: want.get(name, 0) for name, _ in kernels}
        check(counts == want, f"{label}: launches {counts}, expected {want}")
    for name in SERVING_KERNELS if want is None else ():
        check(counts[name] >= 1, f"{label}: kernel {name} launched "
              f"{counts[name]} times on the serving path")
    for name in (FP32_INPUT_STAGE, YARDSTICK):
        check(counts[name] == 0, f"{label}: the fp32 input stage {name} "
              f"launched {counts[name]} times on the bf16 path")
    c, k = spec.classes, cfg.max_detections
    shapes = [(BATCH, c, k, 4), (BATCH, c, k), (BATCH, c, k),
              (BATCH, c), (BATCH,)]
    check([tuple(o.shape) for o in outs] == shapes,
          f"{label}: output shapes {[tuple(o.shape) for o in outs]}")
    check(all(torch.isfinite(o.float()).all().item()
              for o in outs[:2]), f"{label}: non-finite outputs")
    n_valid = int(outs[2].sum().item())
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: step(folded, images, img_w, img_h),
                 iters=10)
    r = {"ms_per_batch": ms, "img_per_s": BATCH / ms * 1e3,
         "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
         "conv_gflop_per_img": num_conv_flops(spec) / 1e9,
         "conv1_filters": spec.layers[0].filters,
         "launches": counts, "launches_by_width": at,
         "valid_detections": n_valid,
         "n_any_max": int(outs[4].max().item())}
    if profile:
        from modelcompression_tpu_torch.cli._profiling import profile_window
        r["profile"], _ = profile_window(
            lambda: step(folded, images, img_w, img_h), steps=2)
    return r


def phase_main(torch, kernels, card):
    """Serve both models; returns each model's launch counts on the
    serving path and on the fp32 (BITMATCH) card-vs-CPU forward."""
    launches = {}
    for label, spec, params in _models(torch):
        r = drive_serving(torch, kernels, spec, params, label)
        r["cpu_reference"] = _agrees_with_cpu(torch, kernels, spec, params)
        launches[label] = r["launches"]
        launches[f"{label}_fp32"] = r["cpu_reference"]["launches"]
        emit({"phase": "main", "ok": True, "model": label, "card": card,
              **r})
    return launches


def phase_server(torch, kernels, card, cfg_name="yolov2-voc.cfg",
                 classes=20, extra=(), want=None, want_cfg=None,
                 label="yolov2_voc", phase="server"):
    """The serve CLI's server (``build_server``) on the card at batch 64
    with the deployment preset (``extra`` adds flags): /healthz, 8 canvases
    submitted and 2 frames posted to /detect as PNG, /stats. Each kernel of
    the serving path must launch, or with ``want`` (launches per batch)
    exactly those counts for every batch served; ``want_cfg`` holds the
    resolved EvalConfig's fields. Returns the launches by width."""
    import urllib.request

    import cv2
    import numpy as np
    from modelcompression_tpu_torch.cli import serve
    from modelcompression_tpu_torch.models import cfg_path
    args = serve.build_parser().parse_args(
        ["--cfg", cfg_path(cfg_name), "--host", "127.0.0.1",
         "--port", "0", "--deployment", "--batch", str(BATCH),
         "--device", "cuda", "--max-wait-ms", "20", *extra])
    httpd, state = serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        for key, value in (want_cfg or {}).items():
            check(getattr(state.cfg, key) == value, f"server {label}: "
                  f"{key} = {getattr(state.cfg, key)!r}, expected {value!r}")
        port = httpd.server_address[1]
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["ok"] and health["classes"] == classes
              and health["device"] == "cuda", f"/healthz said {health}")
        rng = np.random.default_rng(SEED)
        n_req, n_post = 8, 2
        reset_counts(kernels)
        items = [state.submit(rng.integers(0, 256, (NET, NET, 3), np.uint8),
                              float(SRC_W), float(SRC_H))
                 for _ in range(n_req)]
        check(all(it is not None for it in items), "dispatcher queue full")
        for it in items:
            check(it.event.wait(300), "request timed out")
            check(it.error is None, f"request failed: {it.error}")
            check(isinstance(it.result, list), "no detection list")
        posted = []
        for _ in range(n_post):
            ok, png = cv2.imencode(".png", rng.integers(
                0, 256, (SRC_H, SRC_W, 3), np.uint8))
            check(ok, "PNG encoding failed")
            req = urllib.request.Request(base + "/detect", data=bytes(png),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                out = json.loads(r.read())
            check(r.status == 200 and out["width"] == SRC_W
                  and out["height"] == SRC_H
                  and isinstance(out["detections"], list),
                  f"/detect said {r.status}: {str(out)[:200]}")
            posted.append(len(out["detections"]))
        # a batch is counted just after its waiters wake
        deadline = time.monotonic() + 60
        while (state.stats()["images"] < n_req + n_post
               and time.monotonic() < deadline):
            time.sleep(0.01)
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        check(stats["images"] == n_req + n_post,
              f"/stats served {stats['images']}")
        counts, at = read_counts(kernels), read_widths(kernels)
        if want is not None:
            want = {name: stats["batches"] * want.get(name, 0)
                    for name, _ in kernels}
            check(counts == want, f"server {label}: launches {counts} over "
                  f"{stats['batches']} batches, expected {want}")
        for name in SERVING_KERNELS if want is None else ():
            check(counts[name] >= 1, f"server: kernel {name} launched "
                  f"{counts[name]} times")
        for name in (FP32_INPUT_STAGE, YARDSTICK):
            check(counts[name] == 0, f"server: the fp32 input stage {name} "
                  f"launched {counts[name]} times")
        emit({"phase": phase, "ok": True, "card": card, "server": label,
              "requests": n_req, "posted": n_post, "stats": stats,
              "launches": counts, "launches_by_width": at,
              "detections_first": len(items[0].result),
              "detections_posted": posted})
        return at
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def phase_prune(torch, kernels, card, tmp):
    """The prune CLI on full-width YOLOv2-VOC in both magnitude modes, its
    launches and masks checked, then the pruned weights served. Writes the
    random weights to ``tmp``; returns each mode's launch counts, the same
    by width, and the weights' path."""
    from modelcompression_tpu_torch.cli import prune
    from modelcompression_tpu_torch.compress import criteria
    from modelcompression_tpu_torch.models import (
        cfg_path, init_params, load_cfg, load_weights, params_to,
        save_weights,
    )
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    params = init_params(spec, seed=SEED)
    dev_params = params_to(params, "cuda")
    launches, widths = {}, {}
    src = os.path.join(tmp, "yolov2-voc.weights")
    save_weights(src, spec, params)
    for mode, per_layer in (("magnitude", True), ("global", False)):
        out = os.path.join(tmp, f"{mode}.weights")
        reset_counts(kernels)
        t0 = time.perf_counter()
        rc = prune.main(["--cfg", cfg, "--weights", src, "--mode", mode,
                         "--sparsity", str(SPARSITY), "--device", "cuda",
                         "--out", out])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = read_counts(kernels)
        widths[mode] = read_widths(kernels)
        check(rc == 0, f"prune --mode {mode} exited {rc}")
        want = {name: PRUNE_LAUNCHES.get(name, 0) for name, _ in kernels}
        check(counts == want, f"prune --mode {mode}: launches {counts}, "
              f"expected {want}")
        launches[mode] = counts
        name = "perlayer" if per_layer else "global"
        fn = getattr(ct, f"magnitude_masks_{name}")
        ref_fn = getattr(criteria, f"magnitude_masks_{name}")
        ref = ref_fn(dev_params, spec, SPARSITY)
        masks = fn(dev_params, spec, SPARSITY)
        written, _ = load_weights(out, spec)
        for key, m in ref.items():
            w = written[key]["w"].to(m.device)
            check(torch.equal(masks[key], m), f"{mode}: the mask of "
                  f"{key} differs from the reference backend's")
            # the written weights are the params times that mask
            check(torch.equal(w[m], dev_params[key]["w"][m])
                  and not w[~m].any(), f"{mode}: the written weights of "
                  f"{key} are not the reference-masked params")
        zeros = {key: int((~m).sum()) for key, m in ref.items()}
        sizes = {key: m.numel() for key, m in ref.items()}
        if per_layer:
            check(all(zeros[key] == int(SPARSITY * sizes[key])
                      for key in ref), f"{mode}: per-layer zero counts")
        else:
            total = sum(sizes.values())
            check(sum(zeros.values()) == int(SPARSITY * total),
                  f"{mode}: {sum(zeros.values())} zeros of {total}")
        r = {"mode": mode, "sparsity": SPARSITY,
             "achieved": sum(zeros.values()) / sum(sizes.values()),
             "weights": sum(sizes.values()), "launches": counts,
             "cli_s": cli_s, "masks_equal_reference": True,
             "masks_ms": time_ms(torch, lambda: fn(
                 dev_params, spec, SPARSITY), iters=3, warmup=1),
             "reference_masks_ms": time_ms(torch, lambda: ref_fn(
                 dev_params, spec, SPARSITY), iters=2, warmup=1),
             "served": drive_serving(torch, kernels, spec, written,
                                     f"prune {mode}")}
        emit({"phase": "prune", "ok": True, "card": card, **r})
    return launches, widths, src


@contextlib.contextmanager
def without_cv2():
    """``import cv2`` raises ImportError inside, whether or not the machine
    has cv2: the eval phase shows its path needs none."""
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def _run_cli(torch, kernels, main, argv, label):
    """One CLI call with every launch count at 0 before it: (stdout,
    launches, launches by width, seconds). Its output is echoed."""
    reset_counts(kernels)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    check(rc == 0, f"{label} exited {rc}")
    return out, read_counts(kernels), read_widths(kernels), seconds


def _first_batch_equal(torch, kernels, spec, params, samples, names):
    """``evaluate`` over the fixture, its first batch's detections against
    the eval step's on the same 64 canvases (same device and process:
    random-weight scores have near-ties, so only a same-device comparison
    can ask for equality). Also times the step alone: the host time until
    it returns (dispatch) and until its outputs are on the host."""
    import numpy as np
    from modelcompression_tpu_torch.evaluation import (
        Detection, EvalConfig, evaluate, make_eval_step,
    )
    from modelcompression_tpu_torch.evaluation.pipeline import _prep_batch
    from modelcompression_tpu_torch.models import fold_batchnorm, params_to
    cfg = EvalConfig(batch_size=BATCH, device="cuda")
    res = evaluate(params, spec, samples, names, cfg)
    first = samples[:BATCH]
    canvases = _prep_batch(first, NET, NET, True)
    step = make_eval_step(spec, cfg)
    folded = params_to(fold_batchnorm(params, spec), "cuda")
    reset_counts(kernels)
    outs = [t.cpu().numpy() for t in step(folded, *canvases)]
    check(read_counts(kernels)["input_stage_mma"] == 1,
          "the direct eval step did not launch the mma input stage")
    boxes, scores, valid = outs[:3]
    want = {c: [] for c in names}
    for bi, s in enumerate(first):
        for ci, c in enumerate(names):
            for k in np.nonzero(valid[bi, ci])[0]:
                want[c].append(Detection(s.image_id, float(scores[bi, ci, k]),
                                         tuple(float(x)
                                               for x in boxes[bi, ci, k])))
    ids = {s.image_id for s in first}
    got = {c: [d for d in ds if d.image_id in ids]
           for c, ds in res.detections.items()}
    n = sum(map(len, want.values()))
    check(n > 0 and got == want, "evaluate's first batch differs from the "
          f"eval step's ({sum(map(len, got.values()))} vs {n} detections)")
    dev = [torch.as_tensor(a).to("cuda") for a in canvases]
    dispatch, total = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = step(folded, *dev)
        t1 = time.perf_counter()
        [t.cpu() for t in o]
        dispatch.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
    return {"first_batch_detections": n, "first_batch_equal": True,
            "map50": res.map50, "img_per_s_steady": res.images_per_sec_steady,
            "img_per_s_wall": res.images_per_sec,
            "first_batch_s": res.first_batch_s,
            "nms_overflow_frac": res.nms_overflow_frac,
            "step_dispatch_ms": dispatch, "step_to_host_ms": total}


def phase_eval(torch, kernels, card, tmp, weights, prune_widths):
    """The eval CLI, ``evaluate``, the recall audit and the prune sweep
    with --data on the fixture (module docstring, phase 7). Returns each
    path's launch counts by kernel width and the fixture's .data path."""
    from modelcompression_tpu_torch.cli import eval as eval_cli
    import numpy as np
    from modelcompression_tpu_torch.cli import prune
    from modelcompression_tpu_torch.data import (
        VOC_CLASSES, load_list_dataset, make_fake_voc, read_data_cfg,
    )
    from modelcompression_tpu_torch.data.png import (
        decode_png, encode_png, read_png,
    )
    from modelcompression_tpu_torch.models import (
        cfg_path, load_cfg, load_weights,
    )
    try:
        import cv2  # noqa: F401
        cv2_importable = True
    except ImportError:
        cv2_importable = False
    cfg = cfg_path("yolov2-voc.cfg")
    root = os.path.join(tmp, "voc")
    t0 = time.perf_counter()
    data = make_fake_voc(root, n_images=EVAL_IMAGES, image_size=NET,
                         seed=SEED, classes=VOC_CLASSES)
    fixture_s = time.perf_counter() - t0
    listed = read_data_cfg(data)
    with open(listed["valid"]) as f:
        paths = f.read().split()
    # the host decode of one fixture image written with each PNG row
    # filter (the fixture itself uses filter 0), mean of 3
    img = read_png(paths[0])
    decode_ms = {}
    for ftype in range(5):
        blob = encode_png(img, ftype)
        t0 = time.perf_counter()
        for _ in range(3):
            check(np.array_equal(decode_png(blob), img),
                  f"PNG filter {ftype} does not round-trip")
        decode_ms[ftype] = (time.perf_counter() - t0) / 3 * 1e3
    sub_list = os.path.join(root, "first64.list")
    with open(sub_list, "w") as f:
        f.write("\n".join(paths[:BATCH]) + "\n")
    sub_data = os.path.join(root, "first64.data")
    with open(sub_data, "w") as f:
        f.write(f"valid={sub_list}\nnames={listed['names']}\n")
    base = ["--cfg", cfg, "--weights", weights, "--batch", str(BATCH),
            "--device", "cuda"]
    widths = {}
    n_batches = -(-EVAL_IMAGES // BATCH)
    spec = load_cfg(cfg)
    c1 = spec.layers[0].filters

    out, counts, at, cli_s = _run_cli(torch, kernels, eval_cli.main,
                                      base + ["--data", data], "eval FAST")
    widths["eval"] = at
    want = {name: 0 for name, _ in kernels}
    want["input_stage_mma"] = n_batches
    check(counts == want, f"eval FAST: launches {counts}, expected {want}")
    check(at["input_stage_mma"] == {c1: n_batches},
          f"eval FAST: mma input-stage launches by C {at['input_stage_mma']}")
    m = re.search(r"^mAP@50 \(11-point\): ([0-9.]+)  \[(\d+) images", out,
                  re.M)
    ips = re.search(r"^throughput: ([0-9.]+) img/s steady-state", out, re.M)
    check(m and int(m.group(2)) == EVAL_IMAGES and ips,
          "eval FAST printed no summary")
    r = {"images": EVAL_IMAGES, "batch": BATCH,
         "cv2_importable": cv2_importable,
         "fixture_write_s": fixture_s, "png_decode_ms_by_filter": decode_ms,
         "cli": {"map50_pct": float(m.group(1)),
                 "img_per_s_steady": float(ips.group(1)), "seconds": cli_s,
                 "launches": counts}}

    params, _ = load_weights(weights, spec)
    samples = load_list_dataset(listed["valid"])
    r["evaluate"] = _first_batch_equal(torch, kernels, spec, params, samples,
                                       list(VOC_CLASSES))

    out, counts, at, bm_s = _run_cli(
        torch, kernels, eval_cli.main,
        base + ["--data", sub_data, "--precision", "bitmatch"],
        "eval --precision bitmatch")
    widths["eval_bitmatch"] = at
    check(all(counts[n] == 0 for n in ("input_stage_mma", FP32_INPUT_STAGE,
                                        YARDSTICK)),
          f"eval bitmatch: input-stage launches {counts}")
    m = re.search(r"^mAP@50 \(11-point\): ([0-9.]+)  \[(\d+) images", out,
                  re.M)
    check(m and int(m.group(2)) == BATCH, "eval bitmatch printed no summary")
    r["bitmatch"] = {"images": BATCH, "map50_pct": float(m.group(1)),
                     "seconds": bm_s, "launches": counts}

    out, counts, at, rec_s = _run_cli(torch, kernels, eval_cli.main,
                                      base + ["--data", data, "--recall"],
                                      "eval --recall")
    widths["recall"] = at
    check("recall@IoU>0.5" in out, "eval --recall printed no summary")
    r["recall"] = {"summary": out.strip().splitlines()[-2:],
                   "seconds": rec_s, "launches": counts}

    sweep_out = os.path.join(tmp, "sweep.weights")
    out, counts, at, sw_s = _run_cli(
        torch, kernels, prune.main,
        ["--cfg", cfg, "--weights", weights, "--mode", "magnitude",
         "--sweep", ",".join(map(str, SWEEP_POINTS)), "--data", data,
         "--batch", str(BATCH), "--device", "cuda", "--out", sweep_out],
        "prune --sweep --data")
    widths["sweep"] = at
    want = {name: len(SWEEP_POINTS) * PRUNE_LAUNCHES.get(name, 0)
            for name, _ in kernels}
    want["input_stage_mma"] = len(SWEEP_POINTS) * n_batches
    check(counts == want, f"prune --sweep --data: launches {counts}, "
          f"expected {want}")
    # each point prunes at the widths of phase 6's --mode magnitude call
    want_at = {name: {w: len(SWEEP_POINTS) * n for w, n in by.items()}
               for name, by in prune_widths["magnitude"].items()}
    want_at["input_stage_mma"] = {c1: len(SWEEP_POINTS) * n_batches}
    check(at == want_at, f"prune --sweep --data: launches by width {at}, "
          f"expected {want_at}")
    maps = [float(x) for x in re.findall(r"mAP@50 ([0-9.naif-]+)$", out,
                                         re.M)]
    check(len(maps) == len(SWEEP_POINTS)
          and all(math.isfinite(v) for v in maps),
          f"prune --sweep --data: mAP@50 per point {maps}")
    r["sweep"] = {"points": list(SWEEP_POINTS), "map50_pct": maps,
                  "seconds": sw_s, "launches": counts}
    emit({"phase": "eval", "ok": True, "card": card, **r,
          "launches_by_width": widths})
    return widths, data


# the fine-tune phase: steps of the single pass, the iterate schedule and
# its steps per round, the train CLI's interrupted and total steps
FT_STEPS = 3
ITER_FRACTIONS = (0.5, 0.75)
ITER_STEPS = 2
TRAIN_STEPS = (2, 4)
TIMED_STEPS = 5
# the train CLI's multi-scale band for the cfg's [region] random=1
MULTI_SCALE = (320, 608)
# card against CPU: one BITMATCH step at batch 2
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4  # of a gradient tensor's largest magnitude


def _read_jsonl(path, prefix="train"):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["prefix"] == prefix]


def _map_line(out):
    m = re.search(r"^mAP@50 \(11-point\): ([0-9.]+)  \[(\d+) images", out,
                  re.M)
    check(m, "no mAP summary printed")
    return float(m.group(1)), int(m.group(2))


def _train_batch(torch, b, seed, device, net=NET):
    """A batch of random uint8 images at ``net`` x ``net`` and targets with
    1-3 valid boxes each (max_boxes 30)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, net, net, 3), np.uint8)
    targets = np.zeros((b, 30, 5), np.float32)
    for i in range(b):
        for m in range(int(rng.integers(1, 4))):
            targets[i, m] = [rng.integers(0, 20), rng.uniform(0.2, 0.8),
                             rng.uniform(0.2, 0.8), rng.uniform(0.05, 0.5),
                             rng.uniform(0.05, 0.5)]
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(targets).to(device))


def train_step_timing(torch, spec, params, subdivisions, net=NET):
    """The FAST train step (the cfg's augment: jitter .3 and flip) at
    batch 64 on a fixed device batch at ``net`` x ``net`` (416, or a
    multi-scale size): steady ms per step from CUDA events
    over TIMED_STEPS steps after two warm-up steps, the host's time to
    enqueue them, peak device memory, and the share of the bf16 peak
    counting 3 x the conv FLOPs per image (forward, and the backward's two
    products)."""
    from modelcompression_tpu_torch.models import num_conv_flops, params_to
    from modelcompression_tpu_torch.train import (
        TrainConfig, TrainState, make_optimizer, make_train_step,
    )
    config = TrainConfig.from_spec(spec, subdivisions=subdivisions)
    state = TrainState.create(params_to(params, "cuda"),
                              make_optimizer(config),
                              torch.Generator().manual_seed(SEED))
    step = make_train_step(spec, config)
    images, targets = _train_batch(torch, BATCH, SEED, "cuda", net)
    losses = [float(step(state, images, targets)[1]["loss"])
              for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        _, m = step(state, images, targets)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    end.synchronize()
    ms = start.elapsed_time(end) / TIMED_STEPS
    losses.append(float(m["loss"]))
    check(all(math.isfinite(v) for v in losses),
          f"train step (subdivisions {subdivisions}, {net}): losses {losses}")
    # the conv FLOPs scale with the pixels
    gflop_img = 3 * num_conv_flops(spec) * (net / NET) ** 2 / 1e9
    return {"net": net, "subdivisions": subdivisions, "batch": BATCH,
            "step_ms": ms, "img_per_s": BATCH / ms * 1e3,
            "host_enqueue_ms_per_step": enqueue_ms,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "train_gflop_per_img": gflop_img,
            "bf16_peak_share": gflop_img * 1e9 * BATCH / (ms * 1e-3)
                               / PEAK_OPS_PER_S["bfloat16"],
            "losses": losses, "config": {
                "jitter": config.augment_jitter, "flip": config.augment_flip,
                "lr": config.learning_rate,
                "precision": config.precision.name}}


def _train_profile(torch, spec, params):
    """A profiler window over 2 steps at subdivisions 1: device busy and
    idle share, device operations per step, top kernels."""
    from modelcompression_tpu_torch.cli._profiling import profile_window
    from modelcompression_tpu_torch.models import params_to
    from modelcompression_tpu_torch.train import (
        TrainConfig, TrainState, make_optimizer, make_train_step,
    )
    config = TrainConfig.from_spec(spec, subdivisions=1)
    state = TrainState.create(params_to(params, "cuda"),
                              make_optimizer(config),
                              torch.Generator().manual_seed(SEED))
    step = make_train_step(spec, config)
    images, targets = _train_batch(torch, BATCH, SEED, "cuda")
    summary, _ = profile_window(lambda: step(state, images, targets),
                                steps=2)
    return summary


def step_card_vs_cpu(torch, spec, params, net=NET):
    """One train step at batch 2 and ``net`` x ``net``, augment off,
    subdivisions 1, from the same params on the card and on the CPU: in
    BITMATCH (fp32, TF32 off) and in float64.

    BITMATCH: the loss must agree within 1e-5 relative, and the last conv's
    gradient (a product of the loss gradient and its input, no BN below
    it) within 1e-4 of its largest magnitude. The other fp32 gradients
    pass through batch-statistics BN backwards whose terms nearly cancel at
    random init, so fp32 gets them only to ~1e-1 of their largest
    magnitude on either device: their distances from the float64 step are
    reported, not held. Float64: the same step on both devices (cuDNN's
    fp64 convs on the card), where the cancellation costs nothing the
    tolerance sees: the loss within 1e-5 relative and every gradient
    tensor within 1e-4 of its largest magnitude."""
    import statistics

    from modelcompression_tpu_torch.core.precision import BITMATCH, Precision
    from modelcompression_tpu_torch.train import (
        TrainConfig, TrainState, make_optimizer, make_train_step,
    )
    f64 = Precision(name="float64", compute_dtype=torch.float64,
                    param_dtype=torch.float64)
    images, targets = _train_batch(torch, 2, SEED + 2, "cpu", net)
    # normalized once, on the CPU, so both devices get the same floats: the
    # card's uint8 / 255 multiplies by the reciprocal and is one ulp off the
    # CPU's quotient in about half the pixels, which alone moves a float64
    # step's gradients by up to 5e-2 of their largest magnitude
    images = images.float() / 255.0
    res = {}
    for label, dev, prec in (("cpu", "cpu", BITMATCH),
                             ("cuda", "cuda", BITMATCH),
                             ("cpu_f64", "cpu", f64),
                             ("cuda_f64", "cuda", f64)):
        config = TrainConfig.from_spec(spec, precision=prec, subdivisions=1,
                                       augment_flip=False,
                                       augment_jitter=0.0)
        p = {k: {n: v.to(dev, prec.compute_dtype) for n, v in q.items()}
             for k, q in params.items()}
        state = TrainState.create(p, make_optimizer(config),
                                  torch.Generator().manual_seed(SEED))
        t0 = time.perf_counter()
        state, m = make_train_step(spec, config)(state, images, targets)
        res[label] = {"loss": float(m["loss"]),
                      "s": time.perf_counter() - t0,
                      "grads": {f"{k}/{n}": v.grad.detach().double().cpu()
                                for k, q in state["params"].items()
                                for n, v in q.items() if v.grad is not None}}
    check(len({frozenset(r["grads"]) for r in res.values()}) == 1,
          "gradient sets differ")

    def loss_rel(card, cpu):
        rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        check(math.isfinite(cpu["loss"]) and rel <= STEP_LOSS_RTOL,
              f"step at {net}: loss card {card['loss']} CPU {cpu['loss']} "
              f"(rel {rel} > {STEP_LOSS_RTOL})")
        return rel

    def err(a, b):
        return {key: _max_rel(a[key], b[key]) for key in b}

    cpu, card = res["cpu"], res["cuda"]
    rel32 = loss_rel(card, cpu)
    rel64 = loss_rel(res["cuda_f64"], res["cpu_f64"])
    card_cpu = err(card["grads"], cpu["grads"])
    last = f"conv{spec.conv_indices()[-1]}/w"
    check(card_cpu[last] <= STEP_GRAD_TOL, f"BITMATCH step at {net}: {last} "
          f"differs by {card_cpu[last]} of its max |g| (> {STEP_GRAD_TOL})")
    card_cpu64 = err(res["cuda_f64"]["grads"], res["cpu_f64"]["grads"])
    worst64 = max(card_cpu64, key=card_cpu64.get)
    check(card_cpu64[worst64] <= STEP_GRAD_TOL,
          f"float64 step at {net}: {worst64} differs by "
          f"{card_cpu64[worst64]} of its max |g| (> {STEP_GRAD_TOL})")
    ref = res["cpu_f64"]["grads"]
    to_f64 = {d: err(res[d]["grads"], ref) for d in ("cuda", "cpu")}
    top = sorted(card_cpu, key=card_cpu.get, reverse=True)[:3]
    return {"net": net, "loss_cpu": cpu["loss"], "loss_card": card["loss"],
            "loss_rel": rel32, "loss_f64_cpu": res["cpu_f64"]["loss"],
            "loss_f64_card": res["cuda_f64"]["loss"], "loss_f64_rel": rel64,
            "last_conv_grad_err_over_max_g": card_cpu[last],
            "f64_grad_worst": {worst64: card_cpu64[worst64]},
            "f64_grad_median": statistics.median(card_cpu64.values()),
            "grad_card_vs_cpu_worst": {k: card_cpu[k] for k in top},
            "fp32_grad_vs_f64_worst": {d: max(e.values())
                                       for d, e in to_f64.items()},
            "fp32_grad_vs_f64_median": {d: statistics.median(e.values())
                                        for d, e in to_f64.items()},
            "grad_tensors": len(ref),
            "step_s": {d: res[d]["s"] for d in res}}


def _max_rel(a, b):
    """Largest |a - b| over the largest |b| (0 when both are zero)."""
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale else diff


def phase_finetune(torch, kernels, card, tmp, data, weights):
    """The fine-tune and train CLIs on full-width YOLOv2-VOC and the 160-
    image fixture (module docstring, phase 8). Returns each path's launch
    counts by kernel width."""
    from modelcompression_tpu_torch.cli import finetune
    from modelcompression_tpu_torch.cli import train as train_cli
    from modelcompression_tpu_torch.models import (
        cfg_path, load_cfg, load_weights,
    )
    from modelcompression_tpu_torch.train import loop
    from modelcompression_tpu_torch.utils.checkpoint import (
        latest_checkpoint, load_checkpoint,
    )
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    n_batches = -(-EVAL_IMAGES // BATCH)
    base = ["--cfg", cfg, "--data", data, "--batch", str(BATCH),
            "--subdivisions", str(spec.net.subdivisions), "--device", "cuda"]
    r, widths = {"card": card}, {}
    params, _ = load_weights(weights, spec)

    # train-step figures (library level, fixed device batches), each
    # printed as soon as it is measured: at 416, and at the smallest and
    # largest sizes of the cfg's multi-scale band (the train CLI's default;
    # its host resize needs cv2, blocked here)
    sub = spec.net.subdivisions
    for key, fn in (("timing", lambda: [
                        train_step_timing(torch, spec, params, s, n)
                        for s, n in ((sub, NET), (1, NET),
                                     (sub, MULTI_SCALE[0]),
                                     (sub, MULTI_SCALE[1]))]),
                    ("profile_subdivisions_1",
                     lambda: _train_profile(torch, spec, params)),
                    ("card_vs_cpu",
                     lambda: [step_card_vs_cpu(torch, spec, params, n)
                              for n in (NET, *MULTI_SCALE)])):
        r[key] = fn()
        emit({"phase": "finetune", "part": key, "card": card,
              key: r[key]})

    def expect(counts, at, label, want, want_at):
        full = {name: want.get(name, 0) for name, _ in kernels}
        check(counts == full, f"{label}: launches {counts}, expected {full}")
        for name, by in want_at.items():
            check(at[name] == by, f"{label}: {name} launches by width "
                  f"{at[name]}, expected {by}")

    # (a) single pass on phase 6's magnitude-pruned weights
    pruned = os.path.join(tmp, "magnitude.weights")
    out_a = os.path.join(tmp, "ft.weights")
    log_a = os.path.join(tmp, "ft.jsonl")
    out, counts, at, secs = _run_cli(
        torch, kernels, finetune.main,
        base + ["--weights", pruned, "--steps", str(FT_STEPS),
                "--preserve-sparsity", "--out", out_a, "--log-jsonl", log_a],
        "finetune --preserve-sparsity")
    widths["finetune"] = at
    c1 = spec.layers[0].filters
    expect(counts, at, "finetune --preserve-sparsity",
           {"input_stage_mma": n_batches},
           {"input_stage_mma": {c1: n_batches}})
    losses = [rec["loss"] for rec in _read_jsonl(log_a)]
    check(losses and all(math.isfinite(v) for v in losses),
          f"finetune: logged losses {losses}")
    src, seen0 = load_weights(pruned, spec)
    got, seen1 = load_weights(out_a, spec)
    check(seen1 == seen0 + FT_STEPS * BATCH,
          f"finetune: seen {seen0} -> {seen1}")
    n_zero = moved = 0
    for k, p in src.items():
        zero = p["w"] == 0
        check(not got[k]["w"][zero].any(), f"finetune: {k} lost a zero")
        n_zero += int(zero.sum())
        moved += int((got[k]["w"] != p["w"]).sum())
    check(moved > 0, "finetune: no weight moved")
    r["single_pass"] = {"steps": FT_STEPS, "seconds": secs,
                        "losses": losses, "zeros_kept": n_zero,
                        "weights_moved": moved, "seen": [seen0, seen1],
                        "map50_pct": _map_line(out)[0], "launches": counts}

    # (b) magnitude iterate, each round's masks timed and checked
    timings = {"mask_ms": [], "train_s": []}
    orig_mask_fn, orig_train = loop.magnitude_mask_fn, loop.train

    def timed_mask_fn(mode, backend):
        fn = orig_mask_fn(mode, backend)

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks = fn(*a, **kw)
            torch.cuda.synchronize()
            timings["mask_ms"].append((time.perf_counter() - t0) * 1e3)
            return masks
        return run

    def timed_train(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = orig_train(*a, **kw)
        torch.cuda.synchronize()
        timings["train_s"].append(time.perf_counter() - t0)
        return state

    ck_b = os.path.join(tmp, "ck_magnitude")
    iterate = ["--steps", str(ITER_STEPS), "--iterate",
               ",".join(map(str, ITER_FRACTIONS))]
    loop.magnitude_mask_fn, loop.train = timed_mask_fn, timed_train
    try:
        out, counts, at, secs = _run_cli(
            torch, kernels, finetune.main,
            base + ["--weights", weights, *iterate, "--iterate-mode",
                    "magnitude", "--ckpt-dir", ck_b,
                    "--out", os.path.join(tmp, "mag.weights")],
            "finetune --iterate magnitude")
    finally:
        loop.magnitude_mask_fn, loop.train = orig_mask_fn, orig_train
    widths["iterate_magnitude"] = at
    n_r = len(ITER_FRACTIONS)
    prune_want = {name: n_r * n for name, n in PRUNE_LAUNCHES.items()}
    s_layer = len(spec.conv_indices()) + 1  # + the padding segment
    expect(counts, at, "finetune --iterate magnitude",
           dict(prune_want, input_stage_mma=n_r * n_batches),
           {name: {s_layer: n} for name, n in prune_want.items()})
    rounds = []
    for ridx, frac in enumerate(ITER_FRACTIONS):
        _, saved, meta = load_checkpoint(os.path.join(ck_b,
                                                      f"step_{ridx:08d}"))
        check(meta["fraction"] == frac, f"round {ridx} meta {meta}")
        for k, m in saved["weight_masks"].items():
            check(int((~m).sum()) == int(frac * m.numel()),
                  f"round {ridx}: {k} has {int((~m).sum())} zeros in its "
                  f"mask, expected {int(frac * m.numel())}")
            check(not saved["params"][k]["w"][~m].any(),
                  f"round {ridx}: {k} has a pruned weight off zero")
        rounds.append({"fraction": frac, "mask_ms": timings["mask_ms"][ridx],
                       "train_s": timings["train_s"][ridx],
                       "map50": meta["metrics"]["map50"]})
    r["iterate_magnitude"] = {"steps_per_round": ITER_STEPS,
                              "seconds": secs, "rounds": rounds,
                              "launches": counts}

    # (c) filter iterate: the evals run the input stage at each width
    out, counts, at, secs = _run_cli(
        torch, kernels, finetune.main,
        base + ["--weights", weights, *iterate, "--iterate-mode",
                "l1_filter", "--out", os.path.join(tmp, "slim.weights")],
        "finetune --iterate l1_filter")
    widths["iterate_l1_filter"] = at
    c_rounds = [int(round(c1 * (1 - f))) for f in ITER_FRACTIONS]
    expect(counts, at, "finetune --iterate l1_filter",
           {"input_stage_mma": n_r * n_batches},
           {"input_stage_mma": {c: n_batches for c in c_rounds}})
    slim = load_cfg(os.path.join(tmp, "slim.cfg"))
    check(slim.layers[0].filters == c_rounds[-1],
          f"slim cfg conv1 filters {slim.layers[0].filters}")
    r["iterate_l1_filter"] = {"conv1_filters": c_rounds, "seconds": secs,
                              "launches_by_c": at["input_stage_mma"]}

    # (e) the train CLI: killed after 2 steps and resumed to 4, against an
    # uninterrupted 4-step run. At 416: the cfg's multi-scale resizes on the
    # host with cv2, blocked here (the step at 320 and 608 runs above)
    t_base = base + ["--no-multi-scale"]
    ck_a, ck_r = os.path.join(tmp, "ck_a"), os.path.join(tmp, "ck_r")
    runs = (("uninterrupted", ["--steps", str(TRAIN_STEPS[1]),
                               "--checkpoint-dir", ck_a]),
            ("killed", ["--steps", str(TRAIN_STEPS[0]),
                        "--checkpoint-dir", ck_r]),
            ("resumed", ["--steps", str(TRAIN_STEPS[1]),
                         "--checkpoint-dir", ck_r, "--resume"]))
    train_s = {}
    # cuDNN's deterministic algorithms, so that the same computation gives
    # the same floats in both runs: the BN backwards amplify a reordered
    # sum (see step_card_vs_cpu)
    torch.backends.cudnn.deterministic = True
    try:
        for label, extra in runs:
            out, counts, at, train_s[label] = _run_cli(
                torch, kernels, train_cli.main, t_base + extra,
                f"train ({label})")
            expect(counts, at, f"train ({label})", {}, {})
    finally:
        torch.backends.cudnn.deterministic = False
    widths["train_resume"] = at
    check("resumed" in out, "the resumed train run did not resume")
    _, sa, _ = load_checkpoint(latest_checkpoint(ck_a))
    _, sb, _ = load_checkpoint(latest_checkpoint(ck_r))
    check(sa["step"] == sb["step"] == TRAIN_STEPS[1]
          and sa["seen"] == sb["seen"] == TRAIN_STEPS[1] * BATCH,
          f"train: step/seen {sa['step']}/{sa['seen']} vs "
          f"{sb['step']}/{sb['seen']}")
    check(torch.equal(sa["rng"].get_state(), sb["rng"].get_state()),
          "train: generator state differs after the resume")
    worst = {"params": 0.0, "momentum": 0.0}
    for k, p in sa["params"].items():
        for n, v in p.items():
            worst["params"] = max(worst["params"],
                                  _max_rel(sb["params"][k][n], v))
    for i, st in sa["optimizer"]["state"].items():
        worst["momentum"] = max(worst["momentum"], _max_rel(
            sb["optimizer"]["state"][i]["momentum_buffer"],
            st["momentum_buffer"]))
    check(max(worst.values()) <= STEP_GRAD_TOL,
          f"train: resumed run differs from the uninterrupted one {worst}")
    r["train_resume"] = {"steps": list(TRAIN_STEPS), "seconds": train_s,
                         "max_err_over_max": worst}
    emit({"phase": "finetune", "ok": True, **r,
          "launches_by_width": widths})
    return widths


# the families phase: YOLOv4-VOC served at its cfg size (416, 20 classes),
# YOLOv3-tiny (80 classes) through the tensor-core input stage, the NMS
# variants at YOLOv4-VOC's NMS shape, and the detect / eval / summary CLIs
FAMILY_CFG = "yolov4-voc.cfg"
V3_TINY_CFG = "yolov3-tiny.cfg"
CLI_CFG = "yolov4-tiny-voc.cfg"
SUMMARY_CFG = "yolov4.cfg"
NMS_K, NMS_PREFILTER, NMS_IOU, NMS_CONF = 32, 128, 0.45, 0.01
DIOU_BETA = 0.6
DETECT_IMAGES = 8


def _family_models(torch):
    from modelcompression_tpu_torch.compress import (
        repack, uniform_filter_fraction_keep_sets,
    )
    from modelcompression_tpu_torch.models import (
        cfg_path, init_params, load_cfg,
    )
    spec = load_cfg(cfg_path(FAMILY_CFG))
    params = init_params(spec, seed=SEED)
    keep = uniform_filter_fraction_keep_sets(spec, params, PRUNE_FRACTION)
    pspec, pparams = repack(spec, params, keep)
    return [("yolov4_voc", spec, params),
            ("yolov4_voc_pruned75", pspec, pparams)]


def _candidates_on_card(torch, spec, params):
    """The serving step's NMS inputs on the card (the FAST forward of
    ``drive_serving``'s batch, decoded): corners (B, N, 4) and class
    scores (B, N, C)."""
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, center_to_corners, decode_heads,
    )
    from modelcompression_tpu_torch.evaluation.pipeline import _network
    from modelcompression_tpu_torch.models import fold_batchnorm, params_to
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    images = torch.randint(0, 256, (BATCH, SRC_H, SRC_W, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    cfg = EvalConfig(precision=FAST, device="cuda")
    folded = params_to(fold_batchnorm(params, spec), "cuda")
    with torch.inference_mode():
        boxes, obj, cls = decode_heads(
            _network(spec, cfg, (SRC_H, SRC_W))(folded, images), spec)
        return center_to_corners(boxes), obj[..., None] * cls


def _bisect_layout(torch, scores):
    """The bisect prefilter's flat layout (``_prune_layout``'s tuple) on
    the card: the thresholded max class scores, one segment per image,
    N - N' of each to drop; and the (B, N) scores."""
    b, n, _ = scores.shape
    m = scores.amax(-1)
    m = torch.where(m > NMS_CONF, m, torch.zeros_like(m))
    seg = torch.arange(b * n, device="cuda", dtype=torch.int32) // n
    n_zero = torch.full((b,), n - NMS_PREFILTER, dtype=torch.int64,
                        device="cuda")
    return (None, m.reshape(-1).contiguous(), [n] * b, seg, n_zero, b), m


def _nms_variants_card_vs_cpu(torch, corners, scores):
    """Each NMS variant at the serving NMS shape, on the card's
    candidates and on the same candidates copied to the CPU: selections
    (valid, boxes) equal, scores equal (soft-NMS: within 1e-6 relative,
    its exp); each timed on the card."""
    from modelcompression_tpu_torch.evaluation import nms
    args = (NMS_IOU, NMS_CONF, NMS_K)
    variants = {
        "default_topk128": lambda b, s: nms.batched_per_class_nms_prefiltered(
            b, s, *args, prefilter=NMS_PREFILTER),
        "diou_topk128": lambda b, s: nms.batched_per_class_nms_prefiltered(
            b, s, *args, prefilter=NMS_PREFILTER, diou=True,
            diou_beta=DIOU_BETA),
        "bisect128": lambda b, s: nms.batched_per_class_nms_prefiltered(
            b, s, *args, prefilter=NMS_PREFILTER, impl="bisect"),
        "padded": lambda b, s: nms.batched_per_class_nms_padded(b, s, *args),
        "soft_gaussian": lambda b, s: nms.batched_per_class_soft_nms(
            b, s, *args),
        "soft_linear": lambda b, s: nms.batched_per_class_soft_nms(
            b, s, *args, linear=True),
    }
    cpu = (corners.cpu(), scores.cpu())
    out = {}
    with torch.inference_mode():
        for name, fn in variants.items():
            got = [t.cpu() for t in fn(corners, scores)]
            t0 = time.perf_counter()
            want = fn(*cpu)
            cpu_s = time.perf_counter() - t0
            check(torch.equal(got[2], want[2])
                  and torch.equal(got[0], want[0]),
                  f"NMS {name}: the card's selections differ from the CPU's "
                  f"({int((got[2] != want[2]).sum())} slots)")
            if name.startswith("soft"):
                rel = ((got[1] - want[1]).abs()
                       / want[1].abs().clamp_min(1e-30)).max().item()
                check(rel <= 1e-6, f"NMS {name}: scores rel {rel} > 1e-6")
            else:
                rel = 0.0
                check(torch.equal(got[1], want[1]),
                      f"NMS {name}: the card's scores differ from the CPU's")
            out[name] = {"ms": time_ms(torch, lambda: fn(corners, scores),
                                       iters=3, warmup=1),
                         "cpu_s": cpu_s, "score_max_rel": rel,
                         "valid": int(want[2].sum())}
    return out


def phase_families(torch, kernels, card, tmp, data):
    """The YOLOv3 / YOLOv4 serving and evaluation path (module docstring,
    phase 9). Returns each path's launches by kernel width and the top-k
    kernel case at the bisect prefilter's shape."""
    from modelcompression_tpu_torch.cli import detect, summary
    from modelcompression_tpu_torch.cli import eval as eval_cli
    from modelcompression_tpu_torch.data import read_data_cfg
    from modelcompression_tpu_torch.evaluation import (
        batched_bisect_prefilter,
    )
    from modelcompression_tpu_torch.models import (
        cfg_path, init_params, load_cfg, save_weights,
    )
    from modelcompression_tpu_torch.ops import input_stage_match
    widths, topk = {}, None
    t_phase = time.perf_counter()

    # (a)-(c) YOLOv4-VOC-416 unpruned and 75%-filter-pruned, each with the
    # top-k and the bisect prefilter; no input stage (conv1 feeds a conv)
    for label, spec, params in _family_models(torch):
        check(not input_stage_match(spec), f"{label}: input stage matches")
        r = drive_serving(torch, kernels, spec, params, label, want={},
                          profile=True)
        widths[label] = r["launches_by_width"]
        r["cpu_reference"] = _agrees_with_cpu(torch, kernels, spec, params,
                                              n_frames=1)
        rb = drive_serving(torch, kernels, spec, params, f"{label} bisect",
                           want=PRUNE_LAUNCHES, nms_prefilter_impl="bisect")
        widths[f"{label}_bisect"] = at = rb["launches_by_width"]
        check(at["topk_radix_select"] == {BATCH: SELECT_LAUNCHES}
              and at[TOPK_YARDSTICK] == {},
              f"{label} bisect: select launches by S "
              f"{at['topk_radix_select']}, count {at[TOPK_YARDSTICK]}")
        corners, scores = _candidates_on_card(torch, spec, params)
        got = batched_bisect_prefilter(corners, scores, NMS_CONF,
                                       NMS_PREFILTER)
        want = batched_bisect_prefilter(corners.cpu(), scores.cpu(),
                                        NMS_CONF, NMS_PREFILTER)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"{label}: the bisect keep-set on the card differs from the "
              "plain route's on the same scores")
        rb["keep_set_equal_plain"] = True
        r["bisect"] = rb
        r["n_candidates"] = scores.shape[1]
        if topk is None:  # the unpruned model's scores
            layout, m = _bisect_layout(torch, scores)
            topk = topk_case(
                torch, layout, "bisect", pad_segment=False,
                library=lambda: torch.topk(m, NMS_PREFILTER, dim=1),
                device_times=True)
            emit({"phase": "families", "ok": True, "kernel": "topk",
                  **topk})
            r["nms_variants"] = _nms_variants_card_vs_cpu(torch, corners,
                                                          scores)
        emit({"phase": "families", "ok": True, "model": label,
              "card": card, **r})

    # the serve CLI on YOLOv4-VOC-416 at the deployment preset, with DIoU
    # from the flags and the bisect prefilter: 5 / 0 / 1 / 1 a batch
    widths["yolov4_voc_server"] = phase_server(
        torch, kernels, card, cfg_name=FAMILY_CFG, label="yolov4_voc",
        phase="families",
        extra=["--diou-nms", "--diou-beta", str(DIOU_BETA),
               "--nms-prefilter-impl", "bisect"],
        want=PRUNE_LAUNCHES,
        want_cfg={"diou_nms": True, "diou_beta": DIOU_BETA,
                  "nms_prefilter_impl": "bisect",
                  "nms_prefilter": NMS_PREFILTER, "conf_thresh": NMS_CONF,
                  "max_detections": NMS_K})

    # (d) YOLOv3-tiny-416, 80 classes: the tensor-core input stage at C=16
    spec = load_cfg(cfg_path(V3_TINY_CFG))
    params = init_params(spec, seed=SEED)
    c1 = spec.layers[0].filters
    r = drive_serving(torch, kernels, spec, params, "yolov3_tiny",
                      want={"input_stage_mma": 1}, profile=True)
    widths["yolov3_tiny"] = at = r["launches_by_width"]
    check(at["input_stage_mma"] == {c1: 1},
          f"yolov3_tiny: mma launches by C {at['input_stage_mma']}")
    r["cpu_reference"] = _agrees_with_cpu(torch, kernels, spec, params)
    widths["yolov3_tiny_fp32"] = read_widths(kernels)
    emit({"phase": "families", "ok": True, "model": "yolov3_tiny",
          "card": card, **r})

    # (e) the CLIs on random-weight YOLOv4-tiny-VOC at 416
    cli_cfg = cfg_path(CLI_CFG)
    cli_spec = load_cfg(cli_cfg)
    weights = os.path.join(tmp, "yolov4-tiny-voc.weights")
    save_weights(weights, cli_spec, init_params(cli_spec, seed=SEED))
    frames = os.path.join(tmp, "frames")
    os.makedirs(frames)
    with open(read_data_cfg(data)["valid"]) as f:
        for path in f.read().split()[:DETECT_IMAGES]:
            shutil.copy(path, frames)
    base = ["--cfg", cli_cfg, "--weights", weights, "--device", "cuda"]
    out, counts, at, det_s = _run_cli(
        torch, kernels, detect.main,
        base + ["--dir", frames, "--out-dir", os.path.join(tmp, "drawn"),
                "--batch", str(DETECT_IMAGES), "--deployment"],
        "detect --dir")
    check(f"over {DETECT_IMAGES} images" in out
          and len(os.listdir(os.path.join(tmp, "drawn"))) == DETECT_IMAGES
          and not any(counts.values()), f"detect --dir: launches {counts}")
    widths["detect"] = at
    n_batches = -(-EVAL_IMAGES // BATCH)
    out, counts, at, ev_s = _run_cli(
        torch, kernels, eval_cli.main,
        base + ["--data", data, "--batch", str(BATCH), "--conf",
                str(NMS_CONF), "--max-det", str(NMS_K), "--diou-nms",
                "--diou-beta", str(DIOU_BETA), "--nms-prefilter",
                str(NMS_PREFILTER), "--nms-prefilter-impl", "bisect"],
        "eval --diou-nms --nms-prefilter-impl bisect")
    want = {name: n_batches * PRUNE_LAUNCHES.get(name, 0)
            for name, _ in kernels}
    check(counts == want, f"eval bisect: launches {counts}, expected {want}")
    check(at["topk_radix_select"] == {BATCH: n_batches * SELECT_LAUNCHES}
          and at[TOPK_YARDSTICK] == {},
          f"eval bisect: select launches by S {at['topk_radix_select']}, "
          f"count {at[TOPK_YARDSTICK]}")
    m = re.search(r"^mAP@50 \(11-point\): ([0-9.]+)  \[(\d+) images", out,
                  re.M)
    check(m and int(m.group(2)) == EVAL_IMAGES, "eval printed no summary")
    widths["eval_diou_bisect"] = at
    out, _, _, sum_s = _run_cli(torch, kernels, summary.main,
                                ["--cfg", cfg_path(SUMMARY_CFG)], "summary")
    foot = out.strip().splitlines()[-1]
    check(foot.startswith("total: 64.43M params"), f"summary: {foot}")
    emit({"phase": "families", "ok": True, "card": card,
          "clis": {"detect_dir_s": det_s, "eval_s": ev_s,
                   "eval_map50_pct": float(m.group(1)),
                   "summary_s": sum_s, "summary_footer": foot},
          "seconds": time.perf_counter() - t_phase})
    return widths, topk


TOPK_ENTRIES = (
    ("radix_select", "topk_radix_select", "pallas_topk.py:55"),
    ("count_le", TOPK_YARDSTICK, "pallas_topk.py:55"),
    ("tie_counts", "topk_tie_counts", "pallas_topk.py:190"),
    ("apply", "topk_apply", "pallas_topk.py:124"),
)


def kernel_entries(cases, launches, topk, prune_launches, eval_widths,
                   ft_widths, fam_widths, fam_topk):
    """The ``kernels`` line: one entry per main-path case of each kernel.
    The tensor-core input stage runs bf16 at C=32 in the unpruned model and
    at C=8 in the pruned one; the fp32 input stage runs on the card-vs-CPU
    (BITMATCH) forward of each model (C=32 and C=8). Both carry the
    yardstick kernel's time and error in their dtype (``prev_ms``,
    ``prev_max_abs_err``); the yardstick (``input_stage``, the first
    CUDA-core kernel) has an entry of its own at fp32 C=32, marked
    ``yardstick``, with 0 launches: no path launches it. The top-k kernels
    run per layer (S=24, the magnitude prune) and globally (S=2) on the
    random weights. ``launches`` is that path's count. The radix select's
    entries time the whole select (``ms`` = ``select_ms``, its 5
    launches; ``pass_ms`` each launch) against the bound of reading its
    inputs once (``bound_ms``; ``pass_bound_ms`` one pass,
    ``four_pass_bound_ms`` the four passes), beside the PR 2 route to the
    same kth, the 31-launch bisection through the count kernel
    (``prev_ms``). Its ``library_ms`` is torch.kthvalue on the |w| vector
    in global mode (S=2), the call that finds the same k-th |w|; no
    single PyTorch call computes the per-layer select (S=24). The count
    kernel (``topk_count_le``) is that bisection's yardstick, marked
    ``yardstick`` with 0 launches, one launch's ``ms`` beside the whole
    ``bisection_ms``. The tie-count and apply entries run at the chunk
    ``prune_flat`` sizes to the input (``chunk``), with PR 2's 16K grid
    beside them (``chunk16k_ms``); no single PyTorch call computes
    their functions. ``eval_launches``, ``finetune_launches`` and
    ``families_launches`` count each case's launches on each path of the
    eval, finetune and families phases, read from the wrappers' counts by
    width (C or S). The families phase adds its own cases: the input
    stages at C=16 (YOLOv3-tiny serving, bf16, and its card-vs-CPU
    forward, fp32) and the top-k kernels at S=64 (the bisect prefilter
    over YOLOv4-VOC's 64 x 10,647 candidates; the radix entry's
    ``library_ms`` is torch.topk of the 128 best per image, the whole
    selection)."""
    def on(widths, source, width):
        return {path: at[source].get(width, 0)
                for path, at in widths.items()}

    def on_eval(source, width):
        return on(eval_widths, source, width)

    def on_finetune(source, width):
        return on(ft_widths, source, width)

    entries = []
    for c_out, dtype, name, model in (
            (32, "bfloat16", "input_stage_mma", "unpruned"),
            (8, "bfloat16", "input_stage_mma[C=8]", "pruned75"),
            (32, "float32", "input_stage_f32", "unpruned_fp32"),
            (8, "float32", "input_stage_f32[C=8]", "pruned75_fp32")):
        r = cases[(c_out, dtype)]
        source = r["kernel"]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"modelcompression_tpu_torch/csrc/{source}.cu",
            "replaces": "modelcompression_tpu/ops/input_stage.py:159",
            "launches": launches[model][source],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "prev_ms": r["prev_ms"],
            "prev_max_abs_err": r["prev_max_abs_err"],
            "eval_launches": on_eval(source, c_out),
            "finetune_launches": on_finetune(source, c_out),
            "families_launches": on(fam_widths, source, c_out)})
    for dtype, name, path in (
            ("bfloat16", "input_stage_mma[C=16]", "yolov3_tiny"),
            ("float32", "input_stage_f32[C=16]", "yolov3_tiny_fp32")):
        r = cases[(16, dtype)]
        source = r["kernel"]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"modelcompression_tpu_torch/csrc/{source}.cu",
            "replaces": "modelcompression_tpu/ops/input_stage.py:159",
            "launches": fam_widths[path][source].get(16, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "prev_ms": r["prev_ms"],
            "prev_max_abs_err": r["prev_max_abs_err"],
            "families_launches": on(fam_widths, source, 16)})
    r = cases[(32, "float32")]
    entries.append({
        "name": f"{YARDSTICK}[fp32]", "route": "cuda",
        "source": f"modelcompression_tpu_torch/csrc/{YARDSTICK}.cu",
        "replaces": "modelcompression_tpu/ops/input_stage.py:159",
        "launches": launches["unpruned_fp32"][YARDSTICK], "yardstick": True,
        "max_abs_err": r["prev_max_abs_err"], "ms": r["prev_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "eval_launches": on_eval(YARDSTICK, 32),
        "finetune_launches": on_finetune(YARDSTICK, 32),
        "families_launches": on(fam_widths, YARDSTICK, 32)})
    def topk_entry(r, key, source, body, name, launches, widths, library):
        k = r[key]
        entry = {
            "name": name, "route": "cuda",
            "source": f"modelcompression_tpu_torch/csrc/{source}.cu",
            "replaces": f"modelcompression_tpu/ops/{body}",
            "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None, **widths}
        if key == "radix_select":
            entry.update({n: k[n] for n in (
                "select_ms", "pass_ms", "pass_bound_ms",
                "four_pass_bound_ms", "prev_ms")})
            entry["prev_computes"] = (
                "the PR 2 route: the 31-round bisection through the count "
                "kernel (topk_count_le), the same kth")
            if library is not None:
                entry["library_ms"] = k["library_ms"]
                entry["library_computes"] = library
        elif key == "count_le":
            entry["yardstick"] = True
            entry["bisection_ms"] = r["bisection_ms"]
        else:
            entry["chunk"] = r["chunk"]
            entry["chunk16k_ms"] = k["chunk16k_ms"]
        return entry

    for s, mode in ((24, "magnitude"), (2, "global")):
        r = topk[(s, "random")]
        for key, source, body in TOPK_ENTRIES:
            entries.append(topk_entry(
                r, key, source, body, f"{source}[S={s}]",
                prune_launches[mode][source],
                {"eval_launches": on_eval(source, s),
                 "finetune_launches": on_finetune(source, s),
                 "families_launches": on(fam_widths, source, s)},
                None if s == 24 else
                "torch.kthvalue: the k-th |w| of the one real segment"))
    s = fam_topk["S"]
    for key, source, body in TOPK_ENTRIES:
        entries.append(topk_entry(
            fam_topk, key, source, body, f"{source}[S={s},bisect]",
            fam_widths["yolov4_voc_bisect"][source].get(s, 0),
            {"families_launches": on(fam_widths, source, s)},
            "torch.topk of the 128 best scores per image: the whole "
            "selection"))
    return entries


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from modelcompression_tpu_torch.ops import KERNELS
    except ImportError as e:
        print(f"chip_smoke: the port's package is not next to this script: "
              f"{e}", file=sys.stderr)
        return 1
    try:
        card = card_line()
        print(card, flush=True)
        emit({"phase": "device", "ok": True, "card": card,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        phase_build(KERNELS)
        cases = phase_kernels(torch)
        topk = phase_topk_kernels(torch)
        launches = phase_main(torch, KERNELS, card)
        phase_server(torch, KERNELS, card)
        with tempfile.TemporaryDirectory() as tmp:
            prune_launches, prune_widths, weights = phase_prune(
                torch, KERNELS, card, tmp)
            with without_cv2():
                eval_widths, data = phase_eval(torch, KERNELS, card, tmp,
                                               weights, prune_widths)
                ft_widths = phase_finetune(torch, KERNELS, card, tmp, data,
                                           weights)
            fam_widths, fam_topk = phase_families(torch, KERNELS, card, tmp,
                                                  data)
        emit({"kernels": kernel_entries(cases, launches, topk,
                                        prune_launches, eval_widths,
                                        ft_widths, fam_widths, fam_topk)})
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
