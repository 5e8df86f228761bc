"""Drive the PyTorch port's serving, magnitude-prune, evaluation,
fine-tune, YOLOv3 / YOLOv4 serving, YOLOv3 / YOLOv4 fine-tune and
structured-prune, int8 (PTQ and QAT), the other compression axes' (GMP,
LAMP, distillation, low-rank, weight sharing and packing), data-parallel,
export, deploy and tensor-parallel paths and the user tools on one NVIDIA
GPU and check them.

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
            the tensor-core (mma) kernel, fp32 the fp32 CUDA-core kernel.
            Top-k/mask (radix select, tie count, apply): the flat layout
            of YOLOv2-VOC's 23 convs (50,634,592 weights, padded),
            per-layer (S=24) and global
            (S=2), on the random weights, on bf16-valued weights (ties), and
            re-pruning pruned weights (0.5 then 0.75; 0.75 then 0.5, where
            the threshold is 0.0): the select's kth and n_below equal its
            plain version's and the bisection's, counts equal, outputs
            bit-equal. The select is timed whole and per launch; tie count
            and apply at the chunk prune_flat sizes to the input and at
            16K.
3b. epilogue  the conv epilogue kernel (bias + linear / leaky / mish in
            place) on every conv output of one FAST forward of YOLOv4-VOC
            416 at batch 64, recorded from the forward (110 launches, one a
            conv, at each conv's width): linear and leaky equal to the
            plain version, mish within one bf16 ulp; then timed over the
            110 and alone at conv 0's 416x416x32 (CUDA events and the
            profiler's device time) beside its bound, the plain version
            and the eager chain it replaced (``library_ms``). Every later
            path holds the epilogue's launches exactly, as the other
            kernels': once a conv of each bf16 card forward that wants no
            gradient, conv 0 left out where the input stage runs it; none
            on BITMATCH, int8, training or traced forwards.
4. main     YOLOv2-VOC 416 (random init, seed 0), FAST precision, the
            deployment config (conf 0.01, K 32, prefilter 128), the fused
            serving step with on-device letterbox from 384x512 frames at
            batch 64: unpruned, then 75%-filter-pruned and repacked. Each
            run starts with every kernel launch count at 0 and fails unless
            each kernel of the path launched (the mma input stage, never
            a CUDA-core one); outputs must be finite with the stated
            shapes, and a small fp32 (BITMATCH) batch must agree with the
            same forward on the CPU (through the fp32 input-stage kernel,
            never the mma). Steady img/s from CUDA
            events.
5. server   the serve CLI's build_server on 127.0.0.1 (--deployment
            --batch 64 --device cuda, random weights): /healthz, a few
            canvases through the dispatcher queue, two PNG frames posted
            to /detect, /stats, shutdown.
6. prune    the prune CLI on full-width YOLOv2-VOC (random weights from seed
            0 written as .weights), --mode magnitude then --mode global at
            --sparsity 0.75 --device cuda. Each call must launch the radix
            select exactly 5 times, the tie-count and apply kernels once;
            the written masks must equal the
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
            --batch 64 (radix select / tie-count / apply launched
            10 / 2 / 2 times; a finite mAP@50 per point). Reports
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
            radix select / tie / apply launched 10 / 2 / 2 times
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
            step with the bisect prefilter: radix select / tie-count
            / apply launched exactly 5 / 1 / 1 times at S=64, its
            keep-set equal to the plain route's on the same scores, timed;
            the top-k kernels against their plain versions at this shape,
            timed as in phase 3 (torch.topk of the 128 best per image beside
            the select); (c) at this NMS shape (B=64, N=10,647, C=20, K=32)
            the default, DIoU (beta 0.6), bisect, nms_padded and soft-NMS
            (Gaussian, linear) on the card against the CPU on the same
            candidates: selections equal (soft-NMS scores within 1e-6
            relative), each timed. The serve CLI's server on yolov4-voc.cfg
            as in phase 5, with --diou-nms --diou-beta 0.6
            --nms-prefilter-impl bisect: exactly 5 / 1 / 1 launches for
            every batch it served. (d) YOLOv3-tiny 416 (80 classes) at batch
            64: exactly 1 tensor-core input-stage launch at C=16 a batch,
            and the fp32 card-vs-CPU forward through the fp32 input stage.
            (e) detect --dir on 8 fixture images and eval --diou-nms
            --nms-prefilter 128 --nms-prefilter-impl bisect on phase 7's
            fixture (5 / 1 / 1 launches a batch), both on random-weight
            YOLOv4-tiny-VOC 416, and summary of yolov4.cfg (608): each exits
            0.
10. families_train  YOLOv4-VOC 416 (random init, seed 0, BN gammas drawn
            uniform in [0.5, 1.5) so bn_gamma ranks are not ties; the
            cfg's batch 64, subdivisions 8, CIoU heads) on phase 7's
            fixture, FAST unless stated: (a) the train step alone, steady
            ms and img/s, peak memory without and with remat, a profiler
            window of one step; one step at batch 2 card vs CPU in float64
            (every gradient within 1e-4 of its max) and BITMATCH (the loss
            within 1e-5 relative; the gradients' distances reported, the
            last conv's too); remat against plain from the same
            params with cuDNN's deterministic algorithms (loss equal,
            params within 1e-4 of their max, two plain steps' distance
            beside it). (b) finetune of YOLOv3-tiny-VOC for 3 steps: finite
            losses, exactly 3 tensor-core input-stage launches at C=16 in
            the final eval. (c) prune of YOLOv4-VOC: --mode magnitude
            --sparsity 0.75 (exactly 5 / 1 / 1 radix / tie /
            apply at S=111, the 110 convs and the padding segment; masks
            equal to the reference backend's, floor(0.75 n) zeros per conv)
            and the top-k kernels against their plain versions at that
            layout, timed as in phase 3; then --mode fpgm --tied group
            --fraction 0.5, --mode bn_gamma --target-flops 0.5 and (d)
            --mode taylor --tied group on 2 batches of 8: no kernel launch,
            each written model reloaded (shortcut widths aligned) and
            served; fpgm and bn_gamma keep-sets equal card vs CPU (scores
            within 1e-5 of a layer's largest; a change only where the
            swapped scores tie within it, reported), Taylor scores on 2
            batches of 2 card vs CPU within 1e-6 of the largest in float64,
            the fp32 distances and the keep-set changes at the 0.5 cut (fp32
            and float64) reported. (e) finetune --iterate 0.5,0.75
            on YOLOv4-VOC: --iterate-mode magnitude (10 / 2 / 2 at
            S=111, each round's masks and zeros checked, mask ms against
            train seconds) and --iterate-mode l1_filter --tied group (each
            round's checkpoint: shortcut widths aligned, each tied group
            one width). Every card-vs-CPU train step (phases 8 and 10) also
            holds its last conv's fp32 gradient on the card no farther
            from the CPU's float64 step than the CPU's own, within 1e-4 of
            its max |g|, and reports both distances.
11. int8     (a) PTQ of full-width YOLOv2-VOC 416 (phase 6's weights)
            calibrated on the first 64 fixture images (8 chunks of 8):
            absmax (no kernel launch), then the 0.999 quantile through the
            radix select (2 selects of 5 launches a chunk at S=33: the 32
            layers' outputs and the input, one segment each), its
            thresholds equal to the plain version's on one chunk, the
            select timed. The all-int8 forward at batch 2 from one fp32
            canvas, card vs CPU: each int8 conv's int32 sums on the card
            bit-equal to the plain version's for the same input; every
            layer run again on the CPU on the card's own input to it (an
            int8 conv's codes at most one step apart, the share reported;
            maxpool, route, reorg and upsample equal; float maps within
            1e-5 of their largest); the two forwards end to end: every int8
            activation at most one step apart, each raw map within what
            its producer's input codes apart allow (|d| (*) |w_q| x
            in_scale x s_w, plus 1e-5 of its largest). The int8
            canvas of the device letterbox bit-equal
            to the bf16 canvas quantized, and the forward from either equal.
            (b) Serving at batch 64 as phase 4 with the int8 forward: the
            unpruned model all-int8, the 75%-pruned repacked one with the
            convs of min(Cin, Cout) >= 64 int8: no kernel launch, the int8
            conv's card route once per int8 conv, ms, img/s and peak memory
            beside phase 4's bf16 steps, a profiler window and the int8
            conv's share of device time. (c) eval --int8 --save-qmodel and
            eval --qmodel on the fixture (3 batches of 64; summaries equal,
            throughput aside), detect --qmodel --dir on 8 fixture images,
            the serve daemon with --qmodel as phase 5 (23 int8 convs a
            batch). (d) YOLOv4-VOC 416 all-int8 (16 calibration images):
            card vs CPU as in (a), every layer (shortcuts, SPP, upsamples,
            routes) held on the card's own input; end to end held for the
            card forward with mish taken on the CPU, the witness that
            mish's ulp (the devices' tanh and softplus) is what makes the
            card's own forward drift, which is reported (a code moved one
            step moves the next conv's sums by up to 127 weight steps);
            served at batch 64 as in (b). (e) finetune --qat --save-qmodel on YOLOv2-VOC (batch 64,
            subdivisions 8, FAST, 3 steps): finite losses, 3 tensor-core
            input-stage launches in the float eval, the exported artifact's
            mAP from eval --qmodel equal to the one finetune printed; the
            QAT train step's steady ms beside the plain step's, in turns.
12. compress on full-width YOLOv2-VOC 416 (phase 6's weights, phase 7's
            fixture; the cfg's batch 64 and subdivisions 8, FAST): (a)
            finetune --gmp 0.75 --gmp-begin 0 --gmp-end 2 --gmp-freq 1 for
            3 steps, per layer and --gmp-global: every due step's fresh
            masks equal to the same recompute through prune_flat's plain
            versions on the same weights, each segment's zeros at least
            floor(f32(s) f32(n)); exactly 15 / 3 / 3 radix /
            tie / apply launches at S=24 (S=2 global) and 3 input-stage
            launches in the eval; each recompute's ms, and the step with a
            recompute every step beside the plain step, in turns. (b)
            prune --mode lamp --sparsity 0.75 (5 / 1 / 1 at S=2; the
            cut through the kernels equal to the stable-argsort rank on
            the same scores, exactly int(0.75 n) zeros; lamp_masks ms
            against its plain route, the per-layer allocation), then
            finetune --iterate 0.5,0.75 --iterate-mode lamp (10 / 2 /
            2 at S=2). (c) finetune --distill: phase 6's unpruned weights
            teach a 75%-L1-pruned, repacked student (--distill-cfg) for 3
            steps: loss_distill finite and positive, 3 input-stage
            launches at C=8 in the eval; the teacher against itself 0 on
            the card; the distilled step beside the plain one, in turns.
            (d) prune --mode lowrank --energy 0.9 (host seconds, the
            factored convs; no kernel launch), the factored model served
            at batch 64 beside phase 4's unfactored img/s; every conv
            factored at full rank, its fp32 forward within 1e-4 max rel of
            the original's. (e) eval --cluster-bits 6 --save-cmodel
            --pack huffman on phase 6's 75%-magnitude-pruned weights (the
            artifact's bytes against the .weights'), the native codec
            loaded, its decode ms against _decode_py's on one layer; the
            artifact's FAST raw maps bit-equal to the reconstructed
            params' (input stage included); detect --cmodel --dir and the
            serve daemon with --cmodel (1 input-stage launch a batch);
            finetune --qat --save-qmodel --pack for 1 step, its packed
            artifact loaded and served by eval --qmodel with the mAP
            finetune printed.
13. parallel_deploy on full-width YOLOv2-VOC 416 (phase 6's weights,
            phase 7's fixture): (a) a mesh one wider than the visible cards
            raises the JAX text ("needs N devices, have M"), --dp 1 builds
            a one-card mesh; (b) eval --dp 1 at batch 64 (FAST): the
            summary equal to eval's, 3 input-stage launches at C=32 in
            each; (c) serve --dp 1 answers 3 requests, /stats and /healthz
            say dp 1, each request's detections equal to the one-device
            step's on its canvas, 1 input-stage launch a batch; (d)
            finetune --dp 1 (one NCCL rank, spawned) for 2 steps at the
            cfg's batch 64 / subdivisions 8, cuDNN deterministic: the
            written params bit-equal to finetune's; again with --gmp 0.75
            --gmp-freq 1 (10 / 2 / 2 radix / tie / apply at
            S=24 and 3 input-stage launches in rank 0, read from the file
            it writes; zeros at least floor(s n)); the step with the mesh
            (BN moments, loss sums and gradients all-reduced) beside the
            plain step, in turns, and a step's count of NCCL all-reduces
            alone (host enqueue ms, CUDA-event ms); (e) export at batch 1 and 64 (BITMATCH,
            no kernel launch): seconds, bytes, the CLI's verify, the
            program's valid flags equal to the live step's, its ms beside
            the live eager step's (CUDA events, 10 steps, in turns); (f)
            deploy --fractions 0.5 --steps 2 --qat-steps 2 --cluster-bits
            6 --export saved_model --eval-batch 64: report.json with the
            JAX keys, wall seconds, the input stage 3 times at C=32 (the
            baseline) and 12 at C=16 (four evals of the slimmed model);
            (g) export --qmodel of deploy's int8 artifact (its int8 convs,
            torch._int_mm on the card, traced): the advisory verify's
            valid-flag agreement and score drift, as the JAX CLI reports.
14. tensor_parallel on full-width YOLOv2-VOC 416 (phase 6's weights,
            phase 7's fixture, the cfg's batch 64 and subdivisions 8, FAST
            unless stated), over a (1, 2) mesh whose two ranks share
            cuda:0 (gloo: NCCL refuses two ranks on one card; gloo takes
            the CUDA tensors of every collective, so nothing is staged):
            (a) finetune --tp 2 on a one-card machine exits 2 with the JAX
            text ("needs 2 devices, have 1"); (b) one float64 TP step
            (batch 16, subdivisions 2) against the plain float64 step from
            the same params: every gathered gradient within 1e-4 of its
            largest magnitude, the params' distance reported; the FAST
            step's, TP and plain, largest relative gradient and parameter
            differences from each other and from the float64 step
            reported; (c) the finetune CLI's ranks with --tp 2 --gmp 0.75
            --gmp-freq 1 for 2 steps: 10 / 2 / 2 radix / tie /
            apply launches at S=24 in each rank (the recompute on the
            gathered weights), 3 input-stage launches at C=32 in rank 0's
            eval, read from each rank's file, zeros in the written weights
            at least floor(s n) a layer; (d) the TP step beside the plain
            step in turns (CUDA events, the plain step on rank 0 alone) and
            a step's collectives by kind with their host ms, the backend
            named. Two ranks on one card measure the code path's host and
            gloo cost, not NVLink.
15. tools   the user tools (``modelcompression_tpu_torch/tools``,
            ``cli/profile_train``) on the card: (a) sensitivity_scan on
            YOLOv2-VOC 416 (phase 6's weights, phase 7's fixture, batch
            64), conv 0, a mid and the last prunable conv at 0.25 / 0.5 /
            0.75: the mma input stage 3 times an evaluation, at C=32 for
            the baseline and the other convs' cuts and at C=24 / 16 / 8
            for conv 0's; then the input stages against their plain
            versions at the new widths (C=24 and C=12, bf16 and fp32, at
            batch 64 and 416), at the sweeps' evaluation shape (batch 8,
            96x96, C=16 / 12 / 8 / 4, bf16) and at the BITMATCH check's
            (batch 4, 128x128, C=16, fp32); (b) sweep_fixture --criterion
            magnitude, global and lamp at 40 base and 10 fine-tune steps:
            15 / 3 / 3 radix / tie / apply launches (at S=7,
            the fixture's 6 convs and the padding, per layer; at S=2
            global and LAMP), every mask equal to prune_flat's plain
            version on the same trained weights, floor(s n) zeros or
            more (per layer for magnitude), the mma input stage at C=16
            in each evaluation; the top-k kernels held and timed at the
            fixture's S=7 and S=2; (c) sweep_l1_iterative --family v2 at
            40 / 10 steps: conv 0 at 12, 8, 4 after the rounds, the
            input stage launched at each width; (d) profile_train, one
            stage table (75%-pruned, batch 64) and a trace's top device
            operations; (e) bitmatch_check: raw maps card vs CPU within
            1e-4 max rel, the same detection count on both, the fp32
            input stage 3 times at C=16; (f) gen_anchors, partial_weights
            (Darknet-19's 18 convs, equal to the source's) and
            lowrank_scan on phase 6's weights and phase
            7's fixture; (g) one perf_ledger line to a temporary path,
            read back with the card's name and power limit.

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
# the conv epilogue kernel (ops/conv_epilogue.py): launched once a conv by
# every bf16 card forward that wants no gradient, conv 0 left out where
# the input stage runs it
EPILOGUE = "conv_epilogue"
# the fp32 (BITMATCH) route's input stage, never launched while serving
FP32_INPUT_STAGE = "input_stage_f32"
# launches of one magnitude prune: the radix select's 4 histogram passes
# and its select launch, then the tie count and the apply
PRUNE_LAUNCHES = {"topk_radix_select": 5, "topk_tie_counts": 1,
                  "topk_apply": 1}
SELECT_LAUNCHES = PRUNE_LAUNCHES["topk_radix_select"]
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


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": n_ops}


def reset_counts(kernels) -> None:
    for k in kernels:
        k.reset()


def int8_counter():
    """The int8 conv's card route, whose ``LAUNCHES`` / ``LAUNCHES_AT``
    count its cuBLASLt GEMMs (not an entry of ``ops.KERNELS``)."""
    from modelcompression_tpu_torch.ops.int8_conv import int8_conv_cuda
    return int8_conv_cuda


def read_counts(kernels) -> dict:
    return {k.source: k.launches for k in kernels}


def read_widths(kernels) -> dict:
    """Each kernel's launches by its width: C for the input stages and the
    conv epilogue, S for the top-k kernels (``ops/_build.Kernel.at``)."""
    return {k.source: dict(k.at) for k in kernels}


def epilogue_convs(spec, fused=None) -> int:
    """The conv epilogue's launches in one bf16 card forward of ``spec``
    that wants no gradient: one a conv, less conv 0 where the tensor-core
    input stage runs it (``fused``; by default where the serving step
    fuses it, ``input_stage_match``)."""
    from modelcompression_tpu_torch.models.cfg import ConvLayer
    from modelcompression_tpu_torch.ops import input_stage_match
    if fused is None:
        fused = input_stage_match(spec)
    return sum(isinstance(l, ConvLayer) for l in spec.layers) - int(fused)


def epilogue_widths(spec) -> dict:
    """``epilogue_convs``'s launches by the conv's output channels C."""
    from modelcompression_tpu_torch.models.cfg import ConvLayer
    from modelcompression_tpu_torch.ops import input_stage_match
    convs = [l for l in spec.layers if isinstance(l, ConvLayer)]
    by = {}
    for l in convs[int(input_stage_match(spec)):]:
        by[l.filters] = by.get(l.filters, 0) + 1
    return by


def forwards_want(spec, n=1) -> dict:
    """The launches of ``n`` bf16 card forwards of ``spec`` through the
    serving step: the tensor-core input stage once a forward where it
    fuses conv 0, and the conv epilogue once a conv it leaves."""
    from modelcompression_tpu_torch.ops import input_stage_match
    want = {EPILOGUE: n * epilogue_convs(spec)}
    if input_stage_match(spec):
        want["input_stage_mma"] = n
    return want


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
    paths = _build.build_all(k.source for k in kernels)
    seconds = time.perf_counter() - t0
    for k in kernels:  # load now, so no later phase pays for it
        _build.load(k.source)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.BUILD_LOG.items()}
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "libraries": {n: os.path.relpath(p) for n, p in paths.items()},
          "ptxas": ptxas,
          "sass_mix": {FP32_INPUT_STAGE: sass_mix(paths[FP32_INPUT_STAGE])}})


def input_stage_case(torch, c_out: int, dtype, gen, batch=BATCH, net=NET,
                     device_times=False):
    """Kernel vs plain version at a path's input-stage shape (``batch`` x
    ``net`` x ``net``; the main path's by default): bf16 on the
    tensor-core kernel, fp32 on the fp32 CUDA-core kernel.
    ``device_times``: the kernel's and the library call's device time as
    well (``device_ms``), for launches shorter than their host cost."""
    from modelcompression_tpu_torch.utils.timing import time_fn
    import torch.nn.functional as F
    from modelcompression_tpu_torch.ops import input_stage as tis
    dev = torch.device("cuda")
    x = torch.rand((batch, net, net, 3), generator=gen, device=dev) \
        .to(dtype)
    w = (torch.randn((c_out, 3, 3, 3), generator=gen, device=dev) * 0.2) \
        .to(dtype)
    b = torch.randn((c_out,), generator=gen, device=dev) * 0.5
    bf16 = dtype == torch.bfloat16

    def kernel():
        if bf16:
            return tis.fused_conv1_pool_mma(x, w, b)
        return tis.fused_conv1_pool_f32(x, w, b)

    got = kernel()
    want = tis.fused_conv1_pool_plain(x, w, b, dtype)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (batch, net // 2, net // 2, c_out),
          f"input_stage shape {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    # fp32: summation order only; bf16: one ulp of the final rounding
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
    check(err <= tol, f"input_stage C={c_out} {dtype}: max abs err {err} "
          f"> tolerance {tol}")

    x_nchw = x.permute(0, 3, 1, 2)  # channels-last storage
    w_cl = w.contiguous(memory_format=torch.channels_last)
    b_lib = b.to(dtype)

    def library():
        return F.max_pool2d(F.leaky_relu(F.conv2d(x_nchw, w_cl, b_lib,
                                                  padding=1), 0.1), 2)

    ms = time_fn(kernel, iters=20, windows=1) * 1e3
    plain_ms = time_fn(lambda: tis.fused_conv1_pool_plain(
        x, w, b, dtype), iters=5, windows=1) * 1e3
    library_ms = time_fn(library, iters=20, windows=1) * 1e3
    elt = x.element_size()
    n_bytes = (x.numel() + w.numel() + got.numel()) * elt + b.numel() * 4
    n_ops = 2 * 27 * c_out * batch * net * net  # 4 phases x 27 taps x C
    name = str(dtype).split(".")[1]
    extra = {}
    if device_times:
        extra.update(device_ms=device_ms(kernel),
                     library_device_ms=device_ms(library))
    return {"c_out": c_out, "dtype": name, "batch": batch, "net": net,
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
    (the wrapper's loop), mean ms over ``iters`` selects after one
    warm-up: the four histogram passes, then the select launch."""
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
            ct._launch(ct.RADIX_SELECT, (bits, seg, kk, hist, kth, below),
                       bits.numel(), S, p)
            ev[p + 1].record()
        ev[-1].synchronize()
        if it:  # the first select warms up
            for p in range(n_launch):
                total[p] += ev[p].elapsed_time(ev[p + 1])
    return [t / iters for t in total]


def device_ms(fn, calls=10):
    """Device time per call of ``fn``: the union of its kernels' device
    intervals over a torch.profiler window of ``calls`` calls, ms. Where launches
    are shorter than the host's time to issue them, CUDA events around a
    run of calls measure the host; this does not. None (not measured)
    where the window recorded no device time at all: late in a long run
    the profiler has dropped the short ctypes launches."""
    from modelcompression_tpu_torch.cli._profiling import profile_window
    busy = profile_window(fn, steps=calls)[0]["device_busy_ms_per_step"]
    return busy if busy > 0 else None


def topk_case(torch, layout, variant, kth_library=False, pad_segment=True,
              library=None, device_times=False):
    """The top-k/mask kernels against their plain versions on the inputs
    a prune of this flat ``layout`` (``_prune_layout``'s tuple) feeds
    them, then timed: outputs equal (every output is a count, a bit
    pattern or a copy of an input). The radix select's kth and n_below
    equal its plain version's and the bisection's rule; the tie-count and
    apply kernels run at the chunk ``prune_flat`` sizes to the input
    (``ct.grid_chunk``), and are timed at the fixed 16K chunk as well
    (``chunk16k_ms``). The select is timed whole (``select_ms``) and per
    launch (``pass_ms``). ``kth_library``:
    time torch.kthvalue for the single real segment's k-th |w|;
    ``library``: another PyTorch call for the whole selection, timed
    instead; ``pad_segment``: the last segment is the padding;
    ``device_times``: each kernel's device time as well (``device_ms``,
    ``chunk16k_device_ms``), for launches shorter than their host cost."""
    from modelcompression_tpu_torch.utils.timing import time_fn
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
    err = {"radix_select": 0.0, "tie_counts": 0.0, "apply": 0.0}

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
                "ms": time_fn(lambda: kernel(*args), iters=10,
                              windows=1) * 1e3,
                "plain_ms": time_fn(lambda: plain(*args), iters=2,
                                    warmup=1, windows=1) * 1e3,
                **bound(n_bytes, n_ops, PEAK_OPS_PER_S["float32"])}

    # the tie table and the apply's chunk offsets at 16K, PR 2's grid
    pc16 = ct.tie_counts_plain(bits, seg, tau, S).long()
    off16 = torch.cumsum(pc16.sum(1), 0) - pc16.sum(1)
    chunks = per_chunk.shape[0]
    real = slice(0, S - 1) if pad_segment else slice(0, S)
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
        "four_pass_bound_ms": 4 * 8 * n / HBM_BYTES_PER_S * 1e3})
    r = {"S": S, "variant": variant, "n": n, "weights": sum(sizes),
         "chunk": chunk, "blocks": chunks,
         "segments_at_threshold_zero": int((tau[real] == 0).sum()),
         "ties_at_threshold": int(pc[:, real].sum()),  # padding excluded
         # bytes: each input read once, each output written once
         "radix_select": select,
         "tie_counts": dict(
             timed("tie_counts", ct.tie_counts_cuda, ct.tie_counts_plain,
                   (bits, seg, tau, S, chunk),
                   8 * n + 4 * S + 4 * chunks * S, 2 * n),
             chunk16k_ms=time_fn(lambda: ct.tie_counts_cuda(
                 bits, seg, tau, S), iters=10, windows=1) * 1e3),
         "apply": dict(
             timed("apply", ct.apply_threshold_cuda,
                   ct.apply_threshold_plain, (ones,) + rest + (chunk,),
                   16 * n + 12 * S + 8 * chunks, 4 * n),
             chunk16k_ms=time_fn(lambda: ct.apply_threshold_cuda(
                 ones, bits, seg, tau, budget, seg_start, off16), iters=10,
                 windows=1) * 1e3),
         "kthvalue_ms": None}
    if library is not None:
        r["kthvalue_ms"] = time_fn(library, iters=3, warmup=1,
                                   windows=1) * 1e3
    if kth_library:
        # the one PyTorch call for the select's job: the k-th |w|
        absw = cat[:sum(sizes)].abs()
        kk = int(k[0]) + 1
        kv = torch.kthvalue(absw, kk).values.reshape(1)
        check(int(tm.abs_bits(kv)[0]) == int(kth[0]),
              f"{label}: torch.kthvalue disagrees with the bisection")
        if variant == "random":  # the main path's case; ~0.4 s a call
            r["kthvalue_ms"] = time_fn(lambda: torch.kthvalue(absw, kk),
                                       iters=3, warmup=1, windows=1) * 1e3
    select["library_ms"] = r["kthvalue_ms"]
    if device_times:
        for key, fn in (
                ("radix_select", lambda: ct.radix_select_cuda(bits, seg, k,
                                                              S)),
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


# the conv epilogue's shapes: every conv output of YOLOv4-VOC 416's FAST
# forward at batch 64 (72 mish, 35 leaky, 3 linear convs)
EPILOGUE_CFG = "yolov4-voc.cfg"


def _epilogue_inputs(torch):
    """One FAST ``forward_folded`` of YOLOv4-VOC 416 (random init, seed 0)
    on a random batch, watching the epilogue's dispatch: a copy of each
    conv's output before its epilogue, its bias and activation, in the
    forward's order. Checks the forward launched the kernel once a conv."""
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.models import (
        cfg_path, conv_key, fold_batchnorm, forward_folded, init_params,
        load_cfg, params_to,
    )
    from modelcompression_tpu_torch.models.cfg import ConvLayer
    from modelcompression_tpu_torch.ops import conv_epilogue as ce
    spec = load_cfg(cfg_path(EPILOGUE_CFG))
    convs = [(i, l) for i, l in enumerate(spec.layers)
             if isinstance(l, ConvLayer)]
    folded = params_to(fold_batchnorm(init_params(spec, seed=SEED), spec),
                       "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.rand((BATCH, NET, NET, 3), generator=gen, device="cuda")
    outputs, real = [], ce.takes

    def watching(y, kind):
        took = real(y, kind)
        if took:
            outputs.append((y.clone(), kind))
        return took

    ce.takes, n0 = watching, ce.KERNEL.launches
    try:
        with torch.inference_mode():
            forward_folded(folded, x, spec, FAST)
    finally:
        ce.takes = real
    torch.cuda.synchronize()
    n = ce.KERNEL.launches - n0
    check(n == len(outputs) == len(convs), f"epilogue: {n} launches, "
          f"{len(outputs)} taken, for {len(convs)} convs")
    check([(y.shape[1], k) for y, k in outputs]
          == [(l.filters, l.activation) for _, l in convs],
          "epilogue: the outputs' widths and activations are not the convs'")
    return [(y, folded[conv_key(i)]["bias"].float(), k)
            for (y, k), (i, _) in zip(outputs, convs)]


def phase_epilogue(torch):
    """The conv epilogue kernel against its plain version on every conv
    output of one YOLOv4-VOC forward at batch 64 (linear and leaky equal,
    mish within one bf16 ulp), then timed over the forward's 110 launches
    and alone at the largest output (conv 0, 416x416x32): kernel ms by
    CUDA events and by the profiler's device time, its bound (the bytes
    once over 3.35 TB/s), the plain version's ms and the eager chain the
    folded forward ran before the kernel (``library_ms``: bias cast, add
    and activation passes; the port no longer calls it there)."""
    from modelcompression_tpu_torch.utils.timing import time_fn
    from modelcompression_tpu_torch.models import darknet
    from modelcompression_tpu_torch.ops import conv_epilogue as ce
    ce.KERNEL.reset()
    records = _epilogue_inputs(torch)
    forward_at = dict(ce.KERNEL.at)
    worst = {}
    for y, b, kind in records:
        want = ce.bias_act_plain(y, b, kind)
        got = ce.bias_act_cuda(y.clone(), b, kind)
        ulp = torch.clamp(want.float().abs() * 2.0 ** -7, min=2.0 ** -133)
        ulps = ((got.float() - want.float()).abs() / ulp).max().item()
        worst[kind] = max(worst.get(kind, 0.0), ulps)
        check(ulps <= 1.0 if kind == "mish" else torch.equal(got, want),
              f"epilogue {kind} C={y.shape[1]}: {ulps} bf16 ulps from the "
              f"plain version")
        del want, got
    torch.cuda.synchronize()

    def n_bytes(rs):  # bf16 read and written once, the fp32 bias read once
        return sum(4 * y.numel() + 4 * b.numel() for y, b, _ in rs)

    def timed(rs, iters):
        def kernel():
            for y, b, kind in rs:
                ce.bias_act_cuda(y, b, kind)

        def plain():
            for y, b, kind in rs:
                ce.bias_act_plain(y, b, kind)

        def library():
            for y, b, kind in rs:
                darknet._activate(y + darknet._per_channel(b, y.dtype), kind)

        ms = time_fn(kernel, iters=iters, windows=1) * 1e3
        dev = device_ms(kernel, calls=3)
        bound_ms = n_bytes(rs) / HBM_BYTES_PER_S * 1e3
        return {"launches": len(rs),
                "elements": sum(y.numel() for y, _, _ in rs),
                "bytes": n_bytes(rs), "bound_ms": bound_ms,
                "bound_by": "bytes", "ms": ms, "device_ms": dev,
                "roofline_pct": (100 * bound_ms / dev if dev else None),
                "plain_ms": time_fn(plain, iters=max(1, iters // 5),
                                    windows=1) * 1e3,
                "library_ms": time_fn(library, iters=iters, windows=1) * 1e3,
                "library_device_ms": device_ms(library, calls=3)}

    forward = timed(records, iters=10)
    largest = timed(records[:1], iters=50)
    kinds = {}
    for _, _, kind in records:
        kinds[kind] = kinds.get(kind, 0) + 1
    r = {"cfg": EPILOGUE_CFG, "batch": BATCH, "net": NET,
         "convs_by_activation": kinds,
         "vector_path_convs": sum(y.shape[1] % 8 == 0 for y, _, _ in records),
         "max_ulps_from_plain": worst, "forward": forward,
         "largest": {"shape": list(records[0][0].shape), **largest},
         "forward_launches_by_width": forward_at}
    emit({"phase": "epilogue", "ok": True, **r})
    return r


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
          and counts["input_stage_mma"] == 0 and counts[EPILOGUE] == 0,
          f"fp32 forward: input-stage and epilogue launches {counts}")
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
    from modelcompression_tpu_torch.utils.timing import time_fn
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
    epilogue = epilogue_convs(spec)  # the step's one forward
    check(counts[EPILOGUE] == epilogue, f"{label}: {counts[EPILOGUE]} conv "
          f"epilogue launches, expected {epilogue}")
    if want is not None:
        want = {k.source: want.get(k.source, 0) for k in kernels}
        want[EPILOGUE] = epilogue
        check(counts == want, f"{label}: launches {counts}, expected {want}")
    for name in SERVING_KERNELS if want is None else ():
        check(counts[name] >= 1, f"{label}: kernel {name} launched "
              f"{counts[name]} times on the serving path")
    check(counts[FP32_INPUT_STAGE] == 0, f"{label}: the fp32 input stage "
          f"launched {counts[FP32_INPUT_STAGE]} times on the bf16 path")
    c, k = spec.classes, cfg.max_detections
    shapes = [(BATCH, c, k, 4), (BATCH, c, k), (BATCH, c, k),
              (BATCH, c), (BATCH,)]
    check([tuple(o.shape) for o in outs] == shapes,
          f"{label}: output shapes {[tuple(o.shape) for o in outs]}")
    check(all(torch.isfinite(o.float()).all().item()
              for o in outs[:2]), f"{label}: non-finite outputs")
    n_valid = int(outs[2].sum().item())
    torch.cuda.reset_peak_memory_stats()
    ms = time_fn(lambda: step(folded, images, img_w, img_h),
                 iters=10, windows=1) * 1e3
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
    serving path and on the fp32 (BITMATCH) card-vs-CPU forward, and each
    model's phase line."""
    launches, lines = {}, {}
    for label, spec, params in _models(torch):
        r = drive_serving(torch, kernels, spec, params, label)
        r["cpu_reference"] = _agrees_with_cpu(torch, kernels, spec, params)
        launches[label] = r["launches"]
        launches[f"{label}_fp32"] = r["cpu_reference"]["launches"]
        lines[label] = r
        emit({"phase": "main", "ok": True, "model": label, "card": card,
              **r})
    return launches, lines


def phase_server(torch, kernels, card, cfg_name="yolov2-voc.cfg",
                 classes=20, extra=(), want=None, want_cfg=None,
                 label="yolov2_voc", phase="server", int8_convs=None):
    """The serve CLI's server (``build_server``) on the card at batch 64
    with the deployment preset (``extra`` adds flags): /healthz, 8 canvases
    submitted and 2 frames posted to /detect as PNG, /stats. Each kernel of
    the serving path must launch, or with ``want`` (launches per batch)
    exactly those counts for every batch served; ``want_cfg`` holds the
    resolved EvalConfig's fields; with ``int8_convs`` the int8 conv's card
    route runs that many times a batch (and the conv epilogue never, else
    once a conv of the float forward). Returns the launches by width."""
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
        int8 = int8_counter()
        int8.LAUNCHES = 0
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
        epilogue = stats["batches"] * (
            0 if int8_convs is not None else epilogue_convs(state.spec))
        check(counts[EPILOGUE] == epilogue, f"server {label}: "
              f"{counts[EPILOGUE]} conv epilogue launches over "
              f"{stats['batches']} batches, expected {epilogue}")
        if want is not None:
            want = {k.source: stats["batches"] * want.get(k.source, 0)
                    for k in kernels}
            want[EPILOGUE] = epilogue
            check(counts == want, f"server {label}: launches {counts} over "
                  f"{stats['batches']} batches, expected {want}")
        for name in SERVING_KERNELS if want is None else ():
            check(counts[name] >= 1, f"server: kernel {name} launched "
                  f"{counts[name]} times")
        check(counts[FP32_INPUT_STAGE] == 0, f"server: the fp32 input "
              f"stage launched {counts[FP32_INPUT_STAGE]} times")
        int8_launches = int8.LAUNCHES
        if int8_convs is not None:
            check(int8_launches == stats["batches"] * int8_convs,
                  f"server {label}: {int8_launches} int8 convs over "
                  f"{stats['batches']} batches, expected {int8_convs} a "
                  f"batch")
        emit({"phase": phase, "ok": True, "card": card, "server": label,
              "requests": n_req, "posted": n_post, "stats": stats,
              "launches": counts, "launches_by_width": at,
              "int8_conv_launches": int8_launches,
              "detections_first": len(items[0].result),
              "detections_posted": posted})
        return at
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def magnitude_prune_cli(torch, kernels, cfg, spec, src, dev_params, mode,
                        out, label):
    """``prune --mode {magnitude|global} --sparsity 0.75 --device cuda``
    on ``src``: exactly 5 / 1 / 1 radix / tie / apply
    launches; the written weights are the params times the reference
    (stable argsort) backend's masks on the card, which equal the kernel
    route's, with floor(0.75 n) zeros per conv (global: of all N). The
    written weights are then served at batch 64 (``drive_serving``'s
    default launch rule for specs with the input stage, none without).
    Returns the phase line's fields with ``launches`` and
    ``launches_by_width``."""
    from modelcompression_tpu_torch.utils.timing import time_fn
    from modelcompression_tpu_torch.cli import prune
    from modelcompression_tpu_torch.compress import criteria
    from modelcompression_tpu_torch.models import load_weights
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    from modelcompression_tpu_torch.ops import input_stage_match
    reset_counts(kernels)
    t0 = time.perf_counter()
    rc = prune.main(["--cfg", cfg, "--weights", src, "--mode", mode,
                     "--sparsity", str(SPARSITY), "--device", "cuda",
                     "--out", out])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    widths = read_widths(kernels)
    check(rc == 0, f"{label}: prune --mode {mode} exited {rc}")
    want = {k.source: PRUNE_LAUNCHES.get(k.source, 0) for k in kernels}
    check(counts == want, f"{label}: prune --mode {mode}: launches "
          f"{counts}, expected {want}")
    per_layer = mode == "magnitude"
    name = "perlayer" if per_layer else "global"
    fn = getattr(ct, f"magnitude_masks_{name}")
    ref_fn = getattr(criteria, f"magnitude_masks_{name}")
    ref = ref_fn(dev_params, spec, SPARSITY)
    masks = fn(dev_params, spec, SPARSITY)
    written, _ = load_weights(out, spec)
    for key, m in ref.items():
        w = written[key]["w"].to(m.device)
        check(torch.equal(masks[key], m), f"{label} {mode}: the mask of "
              f"{key} differs from the reference backend's")
        # the written weights are the params times that mask
        check(torch.equal(w[m], dev_params[key]["w"][m])
              and not w[~m].any(), f"{label} {mode}: the written weights "
              f"of {key} are not the reference-masked params")
    zeros = {key: int((~m).sum()) for key, m in ref.items()}
    sizes = {key: m.numel() for key, m in ref.items()}
    if per_layer:
        check(all(zeros[key] == int(SPARSITY * sizes[key]) for key in ref),
              f"{label} {mode}: per-layer zero counts")
    else:
        total = sum(sizes.values())
        check(sum(zeros.values()) == int(SPARSITY * total),
              f"{label} {mode}: {sum(zeros.values())} zeros of {total}")
    return {"mode": mode, "sparsity": SPARSITY,
            "achieved": sum(zeros.values()) / sum(sizes.values()),
            "weights": sum(sizes.values()), "convs": len(sizes),
            "launches": counts, "launches_by_width": widths,
            "cli_s": cli_s, "masks_equal_reference": True,
            "masks_ms": time_fn(lambda: fn(
                dev_params, spec, SPARSITY), iters=3, warmup=1,
                windows=1) * 1e3,
            "reference_masks_ms": time_fn(lambda: ref_fn(
                dev_params, spec, SPARSITY), iters=2, warmup=1,
                windows=1) * 1e3,
            "served": drive_serving(
                torch, kernels, spec, written, f"{label} {mode}",
                want=None if input_stage_match(spec) else {})}


def phase_prune(torch, kernels, card, tmp):
    """The prune CLI on full-width YOLOv2-VOC in both magnitude modes, its
    launches and masks checked, then the pruned weights served. Writes the
    random weights to ``tmp``; returns each mode's launch counts, the same
    by width, and the weights' path."""
    from modelcompression_tpu_torch.models import (
        cfg_path, init_params, load_cfg, params_to, save_weights,
    )
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    params = init_params(spec, seed=SEED)
    dev_params = params_to(params, "cuda")
    launches, widths = {}, {}
    src = os.path.join(tmp, "yolov2-voc.weights")
    save_weights(src, spec, params)
    for mode in ("magnitude", "global"):
        r = magnitude_prune_cli(torch, kernels, cfg, spec, src, dev_params,
                                mode, os.path.join(tmp, f"{mode}.weights"),
                                "yolov2_voc")
        launches[mode] = r["launches"]
        widths[mode] = r.pop("launches_by_width")
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


def expect_launches(kernels, counts, at, label, want, want_at):
    """Exactly ``want`` launches of each kernel (0 where not named), and
    ``want_at`` of the named kernels by width."""
    full = {k.source: want.get(k.source, 0) for k in kernels}
    check(counts == full, f"{label}: launches {counts}, expected {full}")
    for name, by in want_at.items():
        check(at[name] == by, f"{label}: {name} launches by width "
              f"{at[name]}, expected {by}")


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
    counts = read_counts(kernels)
    check(counts["input_stage_mma"] == 1
          and counts[EPILOGUE] == epilogue_convs(spec),
          f"the direct eval step's launches {counts}")
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
    want = {k.source: 0 for k in kernels}
    want.update(forwards_want(spec, n_batches))
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
                                        EPILOGUE)),
          f"eval bitmatch: input-stage and epilogue launches {counts}")
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
    want = {k.source: len(SWEEP_POINTS) * PRUNE_LAUNCHES.get(k.source, 0)
            for k in kernels}
    want.update(forwards_want(spec, len(SWEEP_POINTS) * n_batches))
    check(counts == want, f"prune --sweep --data: launches {counts}, "
          f"expected {want}")
    # each point prunes at the widths of phase 6's --mode magnitude call
    want_at = {name: {w: len(SWEEP_POINTS) * n for w, n in by.items()}
               for name, by in prune_widths["magnitude"].items()}
    want_at["input_stage_mma"] = {c1: len(SWEEP_POINTS) * n_batches}
    want_at[EPILOGUE] = {c: len(SWEEP_POINTS) * n_batches * n
                         for c, n in epilogue_widths(spec).items()}
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


def train_step_timing(torch, spec, params, subdivisions, net=NET,
                      remat=False, timed=TIMED_STEPS, qat=None, gmp=None,
                      distill=None, mesh=None):
    """The FAST train step (the cfg's augment: jitter and flip) at batch
    64 on a fixed device batch at ``net`` x ``net`` (416, or a multi-scale
    size), with or without ``remat``: steady ms per step from CUDA events
    over ``timed`` steps after two warm-up steps, the host's time to
    enqueue them, peak device memory, and the share of the bf16 peak
    counting 3 x the conv FLOPs per image (forward, and the backward's two
    products). ``qat``: a QAT plan (``compress.qat.QATSpec``) the step
    trains with; ``gmp``: a ``compress.GMPSpec`` (the state seeded with
    its all-keep masks); ``distill``: a ``train.DistillPlan``; ``mesh``:
    the parallel step over that mesh (its ranks' grid set up by the
    caller: ``parallel.ranks``), the state placed on this rank's shards."""
    from modelcompression_tpu_torch.compress import gmp_init_masks
    from modelcompression_tpu_torch.models import num_conv_flops, params_to
    from modelcompression_tpu_torch.train import (
        TrainConfig, TrainState, make_optimizer, make_train_step,
    )
    config = TrainConfig.from_spec(spec, subdivisions=subdivisions,
                                   remat=remat, qat=qat, gmp=gmp)
    dev_params = params_to(params, "cuda")
    state = TrainState.create(
        dev_params, make_optimizer(config),
        torch.Generator().manual_seed(SEED),
        weight_masks=(gmp_init_masks(dev_params, spec, gmp)
                      if gmp is not None else None))
    if mesh is not None:
        from modelcompression_tpu_torch.parallel import (
            place_train_state, ranks,
        )
        state = place_train_state(state, mesh, spec,
                                  tp=mesh.shape["model"] > 1,
                                  rank=ranks.rank() or 0)
    step = make_train_step(spec, config, distill=distill, mesh=mesh)
    images, targets = _train_batch(torch, BATCH, SEED, "cuda", net)
    losses = [float(step(state, images, targets)[1]["loss"])
              for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(timed):
        _, m = step(state, images, targets)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / timed
    end.synchronize()
    ms = start.elapsed_time(end) / timed
    losses.append(float(m["loss"]))
    check(all(math.isfinite(v) for v in losses),
          f"train step (subdivisions {subdivisions}, {net}): losses {losses}")
    # the conv FLOPs scale with the pixels
    gflop_img = 3 * num_conv_flops(spec) * (net / NET) ** 2 / 1e9
    return {"net": net, "subdivisions": subdivisions, "batch": BATCH,
            "remat": remat, "qat": qat is not None, "gmp": gmp is not None,
            "distill": distill is not None, "dp": mesh is not None,
            "tp": mesh.shape["model"] if mesh is not None else 0,
            "timed_steps": timed,
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


def _train_profile(torch, spec, params, subdivisions=1, steps=2):
    """A profiler window over ``steps`` FAST steps at ``subdivisions``:
    device busy and idle share, device operations per step, top
    kernels."""
    from modelcompression_tpu_torch.cli._profiling import profile_window
    from modelcompression_tpu_torch.models import params_to
    from modelcompression_tpu_torch.train import (
        TrainConfig, TrainState, make_optimizer, make_train_step,
    )
    config = TrainConfig.from_spec(spec, subdivisions=subdivisions)
    state = TrainState.create(params_to(params, "cuda"),
                              make_optimizer(config),
                              torch.Generator().manual_seed(SEED))
    step = make_train_step(spec, config)
    images, targets = _train_batch(torch, BATCH, SEED, "cuda")
    summary, _ = profile_window(lambda: step(state, images, targets),
                                steps=steps)
    return summary


def step_card_vs_cpu(torch, spec, params, net=NET, hold_last_conv=True):
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
    tensor within 1e-4 of its largest magnitude. ``hold_last_conv=False``
    reports the BITMATCH last conv's card-vs-CPU distance without holding
    it (deep networks carry the batch-stat BN noise into its input). Either
    way the last conv's fp32 gradient on each device is measured against
    the CPU's float64 step, and the card's must be no farther from it than
    the CPU's, within STEP_GRAD_TOL of its max |g|."""
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
    check(card_cpu[last] <= STEP_GRAD_TOL or not hold_last_conv,
          f"BITMATCH step at {net}: {last} differs by {card_cpu[last]} of "
          f"its max |g| (> {STEP_GRAD_TOL})")
    card_cpu64 = err(res["cuda_f64"]["grads"], res["cpu_f64"]["grads"])
    worst64 = max(card_cpu64, key=card_cpu64.get)
    check(card_cpu64[worst64] <= STEP_GRAD_TOL,
          f"float64 step at {net}: {worst64} differs by "
          f"{card_cpu64[worst64]} of its max |g| (> {STEP_GRAD_TOL})")
    ref = res["cpu_f64"]["grads"]
    to_f64 = {d: err(res[d]["grads"], ref) for d in ("cuda", "cpu")}
    last_f64 = {d: e[last] for d, e in to_f64.items()}
    check(last_f64["cuda"] <= last_f64["cpu"] + STEP_GRAD_TOL,
          f"BITMATCH step at {net}: {last} is {last_f64['cuda']} of its max "
          f"|g| from float64 on the card, {last_f64['cpu']} on the CPU")
    top = sorted(card_cpu, key=card_cpu.get, reverse=True)[:3]
    return {"net": net, "loss_cpu": cpu["loss"], "loss_card": card["loss"],
            "loss_rel": rel32, "loss_f64_cpu": res["cpu_f64"]["loss"],
            "loss_f64_card": res["cuda_f64"]["loss"], "loss_f64_rel": rel64,
            "last_conv_grad_err_over_max_g": card_cpu[last],
            "last_conv_fp32_vs_f64": last_f64,
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


def iterate_magnitude(torch, kernels, argv, spec, tmp, tag, eval_want):
    """``finetune ... --iterate-mode magnitude --ckpt-dir``: radix select /
    tie / apply launched 5 / 1 / 1 times a round at S = the
    convs + the padding segment, with ``eval_want`` of the other kernels
    (the rounds' evals); each round's masks (read back from its
    checkpoint) with floor(s n) zeros per conv and its pruned weights zero
    after the round's steps; each round's mask ms against its train
    seconds. Returns (the phase line's fields, launches by width)."""
    from modelcompression_tpu_torch.cli import finetune
    from modelcompression_tpu_torch.train import loop
    from modelcompression_tpu_torch.utils.checkpoint import load_checkpoint
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

    ck = os.path.join(tmp, f"ck_magnitude_{tag}")
    label = f"{tag}: finetune --iterate magnitude"
    loop.magnitude_mask_fn, loop.train = timed_mask_fn, timed_train
    try:
        _, counts, at, secs = _run_cli(
            torch, kernels, finetune.main,
            argv + ["--iterate-mode", "magnitude", "--ckpt-dir", ck,
                    "--out", os.path.join(tmp, f"mag_{tag}.weights")],
            label)
    finally:
        loop.magnitude_mask_fn, loop.train = orig_mask_fn, orig_train
    n_r = len(ITER_FRACTIONS)
    prune_want = {name: n_r * n for name, n in PRUNE_LAUNCHES.items()}
    s_layer = len(spec.conv_indices()) + 1  # + the padding segment
    expect_launches(kernels, counts, at, label, dict(prune_want, **eval_want),
                    {name: {s_layer: n} for name, n in prune_want.items()})
    rounds = []
    for ridx, frac in enumerate(ITER_FRACTIONS):
        _, saved, meta = load_checkpoint(os.path.join(ck,
                                                      f"step_{ridx:08d}"))
        check(meta["fraction"] == frac, f"{label}: round {ridx} meta {meta}")
        for k, m in saved["weight_masks"].items():
            check(int((~m).sum()) == int(frac * m.numel()),
                  f"{label}: round {ridx}: {k} has {int((~m).sum())} zeros "
                  f"in its mask, expected {int(frac * m.numel())}")
            check(not saved["params"][k]["w"][~m].any(),
                  f"{label}: round {ridx}: {k} has a pruned weight off zero")
        rounds.append({"fraction": frac, "mask_ms": timings["mask_ms"][ridx],
                       "train_s": timings["train_s"][ridx],
                       "map50": meta["metrics"]["map50"]})
    shutil.rmtree(ck)
    return ({"steps_per_round": ITER_STEPS, "segments": s_layer,
             "seconds": secs, "rounds": rounds, "launches": counts}, at)


def phase_finetune(torch, kernels, card, tmp, data, weights):
    """The fine-tune and train CLIs on full-width YOLOv2-VOC and the 160-
    image fixture (module docstring, phase 8). Returns each path's launch
    counts by kernel width."""
    from modelcompression_tpu_torch.cli import finetune
    from modelcompression_tpu_torch.cli import train as train_cli
    from modelcompression_tpu_torch.models import (
        cfg_path, load_cfg, load_weights,
    )
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
    expect_launches(kernels, counts, at, "finetune --preserve-sparsity",
                    forwards_want(spec, n_batches),
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
    iterate = ["--steps", str(ITER_STEPS), "--iterate",
               ",".join(map(str, ITER_FRACTIONS))]
    n_r = len(ITER_FRACTIONS)
    r["iterate_magnitude"], widths["iterate_magnitude"] = iterate_magnitude(
        torch, kernels, base + ["--weights", weights, *iterate], spec, tmp,
        "yolov2", forwards_want(spec, n_r * n_batches))

    # (c) filter iterate: the evals run the input stage at each width
    out, counts, at, secs = _run_cli(
        torch, kernels, finetune.main,
        base + ["--weights", weights, *iterate, "--iterate-mode",
                "l1_filter", "--out", os.path.join(tmp, "slim.weights")],
        "finetune --iterate l1_filter")
    widths["iterate_l1_filter"] = at
    c_rounds = [int(round(c1 * (1 - f))) for f in ITER_FRACTIONS]
    expect_launches(kernels, counts, at, "finetune --iterate l1_filter",
                    forwards_want(spec, n_r * n_batches),
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
            expect_launches(kernels, counts, at, f"train ({label})", {}, {})
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
    from modelcompression_tpu_torch.utils.timing import time_fn
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
            out[name] = {"ms": time_fn(lambda: fn(corners, scores),
                                       iters=3, warmup=1, windows=1) * 1e3,
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
        check(at["topk_radix_select"] == {BATCH: SELECT_LAUNCHES},
              f"{label} bisect: select launches by S "
              f"{at['topk_radix_select']}")
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
    # from the flags and the bisect prefilter: 5 / 1 / 1 a batch
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
    # one batch: the conv epilogue once a conv, no input stage
    det_want = dict.fromkeys(counts, 0)
    det_want.update(forwards_want(cli_spec, 1))
    check(f"over {DETECT_IMAGES} images" in out
          and len(os.listdir(os.path.join(tmp, "drawn"))) == DETECT_IMAGES
          and counts == det_want, f"detect --dir: launches {counts}, "
          f"expected {det_want}")
    widths["detect"] = at
    n_batches = -(-EVAL_IMAGES // BATCH)
    out, counts, at, ev_s = _run_cli(
        torch, kernels, eval_cli.main,
        base + ["--data", data, "--batch", str(BATCH), "--conf",
                str(NMS_CONF), "--max-det", str(NMS_K), "--diou-nms",
                "--diou-beta", str(DIOU_BETA), "--nms-prefilter",
                str(NMS_PREFILTER), "--nms-prefilter-impl", "bisect"],
        "eval --diou-nms --nms-prefilter-impl bisect")
    want = {k.source: n_batches * PRUNE_LAUNCHES.get(k.source, 0)
            for k in kernels}
    want.update(forwards_want(cli_spec, n_batches))
    check(counts == want, f"eval bisect: launches {counts}, expected {want}")
    check(at["topk_radix_select"] == {BATCH: n_batches * SELECT_LAUNCHES},
          f"eval bisect: select launches by S {at['topk_radix_select']}")
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


# the families-train phase: YOLOv4-VOC trained, pruned and iterated at
# its cfg's size (416, 20 classes, batch 64 in 8 micro-batches, CIoU), and
# YOLOv3-tiny-VOC fine-tuned (its evals through the tensor-core input stage)
V3_TINY_VOC_CFG = "yolov3-tiny-voc.cfg"
FAMILY_TIMED_STEPS = 2
FILTER_FRACTION = 0.5
FLOP_TARGET = 0.5
TAYLOR_BATCHES, TAYLOR_BATCH = 2, 8
TAYLOR_F64_BATCH = 2
FPGM_SCORE_TOL = 1e-5    # card vs CPU, of the largest score of a layer
TAYLOR_F64_TOL = 1e-6    # float64 card vs CPU, of the largest score


def _random_gammas(torch, params, seed):
    """The BN scales drawn uniform in [0.5, 1.5) from a seeded generator:
    the init's all-ones gammas would make every bn_gamma rank a tie."""
    gen = torch.Generator().manual_seed(seed)
    for p in params.values():
        if "gamma" in p:
            p["gamma"] = torch.rand(p["gamma"].shape, generator=gen) + 0.5
    return params


def remat_against_plain(torch, spec, params):
    """One FAST step at batch 64 and the cfg's subdivisions from the same
    params and draws, plain twice and with remat, with cuDNN's
    deterministic algorithms: the loss must be equal, and the params
    within 1e-4 of each tensor's largest magnitude of the plain run's
    (the backward's atomic adds, in the channels-last maxpool and the
    upsample, sum in any order, so two plain steps differ too: their
    distance is reported beside remat's)."""
    from modelcompression_tpu_torch.models import params_to
    from modelcompression_tpu_torch.train import (
        TrainConfig, TrainState, make_optimizer, make_train_step,
    )
    images, targets = _train_batch(torch, BATCH, SEED + 5, "cuda")
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, False, True):
            config = TrainConfig.from_spec(spec, remat=remat)
            state = TrainState.create(params_to(params, "cuda"),
                                      make_optimizer(config),
                                      torch.Generator().manual_seed(SEED))
            state, m = make_train_step(spec, config)(state, images, targets)
            runs.append((float(m["loss"]),
                         {f"{k}/{n}": v.detach()
                          for k, p in state["params"].items()
                          for n, v in p.items()}))
            del state
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, p0), (l1, p1), (lr, pr) = runs

    def worst(a, b):
        return max(_max_rel(a[k], b[k]) for k in b)
    check(l0 == l1 == lr, f"remat: losses plain {l0}, {l1}, remat {lr}")
    err = worst(pr, p0)
    check(err <= STEP_GRAD_TOL, f"remat: params differ from the plain "
          f"step's by {err} of their max (> {STEP_GRAD_TOL})")
    return {"loss": l0, "params_max_err_over_max": err,
            "plain_vs_plain_max_err_over_max": worst(p1, p0),
            "bit_equal_tensors": sum(torch.equal(pr[k], p0[k]) for k in p0),
            "tensors": len(p0)}


def _score_gap(card, cpu):
    """Largest |card - CPU| of each layer (or group) over its largest CPU
    score, and the worst."""
    import numpy as np
    rel = {str(i): float(np.abs(np.asarray(card[i], np.float64)
                                - np.asarray(cpu[i], np.float64)).max()
                         / max(np.abs(np.asarray(cpu[i])).max(), 1e-30))
           for i in cpu}
    return rel, max(rel.values())


def _keep_changes(card, cpu):
    """Convs whose keep-sets differ card vs CPU, with how many filters."""
    import numpy as np
    return {str(i): int(len(np.setxor1d(card[i], cpu[i])))
            for i in cpu if not np.array_equal(card[i], cpu[i])}


def structured_card_vs_cpu(torch, spec, params, mode):
    """The keep-sets of ``prune --mode fpgm --tied group --fraction 0.5``
    or ``--mode bn_gamma --target-flops 0.5``, built from the same params
    on the card and on the CPU: the scores (filter, tied-group and CSP)
    within FPGM_SCORE_TOL of each layer's largest (bn_gamma: equal, they
    are the gammas), and the keep-sets equal. FPGM: a keep-set change is
    allowed only where the scores it swapped lie within that tolerance of
    each other (a tie), and is reported."""
    import numpy as np
    from modelcompression_tpu_torch import compress as tc
    from modelcompression_tpu_torch.models import params_to
    out, keeps, scores = {}, {}, {}
    for dev in ("cuda", "cpu"):
        p = params_to(params, dev)
        t0 = time.perf_counter()
        sc = {"filter": tc.filter_scores_device(p, spec, mode),
              "group": tc.tied_group_scores_device(p, spec, mode),
              "csp": {i: s for i, (_, s) in tc.csp_balanced_scores_device(
                  p, spec, mode).items()}}
        if mode == "fpgm":
            keeps[dev] = tc.uniform_filter_fraction_keep_sets(
                spec, p, FILTER_FRACTION, criterion=mode, tied="group")
        else:
            keeps[dev], sched = tc.flop_targeted_keep_sets(
                spec, sc["filter"], FLOP_TARGET,
                csp_scores=tc.csp_balanced_scores_device(p, spec, mode))
            out["schedule_convs"] = len(sched)
        out[f"{dev}_s"] = time.perf_counter() - t0
        scores[dev] = sc
    tol = FPGM_SCORE_TOL if mode == "fpgm" else 0.0
    for kind in scores["cpu"]:
        rel, worst = _score_gap(scores["cuda"][kind], scores["cpu"][kind]) \
            if scores["cpu"][kind] else ({}, 0.0)
        check(worst <= tol, f"{mode}: {kind} scores card vs CPU differ by "
              f"{worst} of the largest (> {tol})")
        out[f"{kind}_scores_max_err_over_max"] = worst
    changes = _keep_changes(keeps["cuda"], keeps["cpu"])
    if changes:
        check(mode == "fpgm", f"{mode}: keep-sets differ card vs CPU "
              f"{changes}")
        # each conv's rank key: its own scores, its tied group's or (CSP
        # source) its balanced scores
        key = dict(scores["cpu"]["filter"])
        key.update(scores["cpu"]["csp"])
        key.update({i: s for g, s in scores["cpu"]["group"].items()
                    for i in g})
        for i in changes:  # each swap must be a tie within the tolerance
            sc = np.asarray(key[int(i)])
            swapped = np.setxor1d(keeps["cuda"][int(i)],
                                  keeps["cpu"][int(i)])
            check(np.ptp(sc[swapped]) <= 2 * tol * np.abs(sc).max(),
                  f"{mode}: conv {i} keep-set change is not a tie")
    out["keep_set_changes"] = changes
    out["pruned_convs"] = len(keeps["cpu"])
    return out, keeps["cuda"]


def taylor_card_vs_cpu(torch, spec, params, data):
    """Taylor scores with tied groups (``taylor_scores_with_groups``) on
    TAYLOR_BATCHES batches of TAYLOR_F64_BATCH fixture images, from the
    same params on the card and on the CPU: in float64 within
    TAYLOR_F64_TOL of each layer's (group's) largest score; in fp32
    (BITMATCH) the card-vs-CPU and fp32-vs-float64 distances reported, and
    the keep-sets at the CLI's 0.5 cut (each untied conv and each tied
    group ranked on its own scores, as ``taylor_filter_keep_sets(...,
    tied='group')``) compared card vs CPU: the filters that change, per
    conv or group, reported in fp32 and in float64."""
    import itertools

    import numpy as np
    from modelcompression_tpu_torch.compress import taylor_scores_with_groups
    from modelcompression_tpu_torch.compress.criteria import (
        _keep_from_scores,
    )
    from modelcompression_tpu_torch.core.precision import BITMATCH, Precision
    from modelcompression_tpu_torch.data.voc import (
        load_list_dataset, read_data_cfg,
    )
    from modelcompression_tpu_torch.train.loader import BatchLoader
    f64 = Precision(name="float64", compute_dtype=torch.float64,
                    param_dtype=torch.float64)
    samples = load_list_dataset(read_data_cfg(data)["train"])
    loader = BatchLoader(samples, TAYLOR_F64_BATCH, NET, NET, seed=SEED,
                         device="cpu")
    # normalized once, on the CPU, so both devices get the same floats
    # (step_card_vs_cpu: the card's uint8 / 255 is one ulp off the CPU's in
    # about half the pixels, which moves gradients at random init)
    batches = [(images.float() / 255.0, targets) for images, targets in
               itertools.islice(iter(loader), TAYLOR_BATCHES)]
    res = {}
    for label, dev, prec in (("cuda_f64", "cuda", f64),
                             ("cpu_f64", "cpu", f64),
                             ("cuda_fp32", "cuda", BITMATCH),
                             ("cpu_fp32", "cpu", BITMATCH)):
        p = {k: {n: v.to(dev, prec.param_dtype) for n, v in q.items()}
             for k, q in params.items()}
        t0 = time.perf_counter()
        untied, groups = taylor_scores_with_groups(p, spec, batches,
                                                   precision=prec)
        res[label] = ({str(i): s for i, s in untied.items()}
                      | {str(g): s for g, s in groups.items()},
                      time.perf_counter() - t0)
    rel64, worst64 = _score_gap(res["cuda_f64"][0], res["cpu_f64"][0])
    check(worst64 <= TAYLOR_F64_TOL, f"taylor float64 card vs CPU: "
          f"{worst64} of the largest score (> {TAYLOR_F64_TOL})")
    _, worst32 = _score_gap(res["cuda_fp32"][0], res["cpu_fp32"][0])
    to64 = {d: _score_gap(res[f"{d}_fp32"][0], res["cpu_f64"][0])[1]
            for d in ("cuda", "cpu")}
    keeps = {label: {key: _keep_from_scores(np.asarray(sc),
                                            FILTER_FRACTION)
                     for key, sc in scores.items()}
             for label, (scores, _) in res.items()}
    changes = {prec: _keep_changes(keeps[f"cuda_{prec}"],
                                   keeps[f"cpu_{prec}"])
               for prec in ("fp32", "f64")}
    return {"batches": TAYLOR_BATCHES, "batch": TAYLOR_F64_BATCH,
            "scored": len(rel64), "f64_max_err_over_max": worst64,
            "fp32_card_vs_cpu_max_err_over_max": worst32,
            "fp32_vs_f64_max_err_over_max": to64,
            "keep_fraction": FILTER_FRACTION,
            "keep_set_changes": changes,
            "filters_changed": {prec: sum(c.values())
                                for prec, c in changes.items()},
            "filters_kept": sum(len(k) for k in keeps["cpu_fp32"].values()),
            "seconds": {k: v[1] for k, v in res.items()}}


def _shortcuts_aligned(spec):
    """Each [shortcut] adds two inputs of one width."""
    from modelcompression_tpu_torch.models.cfg import (
        ShortcutLayer, out_channels,
    )
    oc = out_channels(spec)
    return all(oc[i - 1] == oc[l.from_layer]
               for i, l in enumerate(spec.layers)
               if isinstance(l, ShortcutLayer))


def spec_gflop(spec):
    from modelcompression_tpu_torch.models import num_conv_flops
    return num_conv_flops(spec) / 1e9


def phase_families_train(torch, kernels, card, tmp, data):
    """Fine-tune and structured-prune the YOLOv3 / YOLOv4 families (module
    docstring, phase 10). Returns each path's launches by kernel width and
    the top-k kernel case at YOLOv4-VOC's per-layer layout."""
    from modelcompression_tpu_torch.cli import finetune, prune
    from modelcompression_tpu_torch.compress import tied_conv_groups
    from modelcompression_tpu_torch.models import (
        cfg_path, init_params, load_cfg, load_weights, params_to,
        save_weights,
    )
    from modelcompression_tpu_torch.utils.checkpoint import load_checkpoint
    t_phase = time.perf_counter()
    widths = {}
    n_batches = -(-EVAL_IMAGES // BATCH)

    def done(part, **fields):
        emit({"phase": "families_train", "ok": True, "part": part,
              "card": card, **fields})

    cfg = cfg_path(FAMILY_CFG)
    spec = load_cfg(cfg)
    check({spec.layers[i].iou_loss for i in spec.head_indices()}
          == {"ciou"}, "yolov4-voc.cfg heads are not CIoU")
    params = _random_gammas(torch, init_params(spec, seed=SEED), SEED)
    sub = spec.net.subdivisions

    # (a) the train step alone: timing and memory without and with remat,
    # a profiler window, card vs CPU at batch 2, remat against plain
    timing = [train_step_timing(torch, spec, params, sub, remat=remat,
                                timed=FAMILY_TIMED_STEPS)
              for remat in (False, True)]
    done("train_step", timing=timing)
    done("train_profile", profile=_train_profile(torch, spec, params, sub,
                                                 steps=1))
    done("card_vs_cpu", card_vs_cpu=step_card_vs_cpu(
        torch, spec, params, hold_last_conv=False))
    done("remat", remat=remat_against_plain(torch, spec, params))

    # (b) finetune YOLOv3-tiny-VOC: its final eval through the tensor-core
    # input stage at C=16, once a batch
    v3_cfg = cfg_path(V3_TINY_VOC_CFG)
    v3 = load_cfg(v3_cfg)
    v3_weights = os.path.join(tmp, "yolov3-tiny-voc.weights")
    save_weights(v3_weights, v3, init_params(v3, seed=SEED))
    log = os.path.join(tmp, "ft_v3.jsonl")
    _, counts, at, secs = _run_cli(
        torch, kernels, finetune.main,
        ["--cfg", v3_cfg, "--weights", v3_weights, "--data", data,
         "--batch", str(BATCH), "--subdivisions", str(v3.net.subdivisions),
         "--device", "cuda", "--steps", str(FT_STEPS), "--out",
         os.path.join(tmp, "ft_v3.weights"), "--log-jsonl", log],
        "finetune yolov3-tiny-voc")
    c1 = v3.layers[0].filters
    expect_launches(kernels, counts, at, "finetune yolov3-tiny-voc",
                    forwards_want(v3, n_batches),
                    {"input_stage_mma": {c1: n_batches}})
    widths["finetune_yolov3_tiny"] = at
    losses = [rec["loss"] for rec in _read_jsonl(log)]
    check(losses and all(math.isfinite(v) for v in losses),
          f"finetune yolov3-tiny-voc: logged losses {losses}")
    done("finetune_yolov3_tiny", steps=FT_STEPS, seconds=secs,
         losses=losses, launches=counts)

    # (c) prune YOLOv4-VOC: magnitude (S = 110 convs + padding), then the
    # structured modes; every written model reloaded and served
    src = os.path.join(tmp, "yolov4-voc.weights")
    save_weights(src, spec, params)
    dev_params = params_to(params, "cuda")
    r = magnitude_prune_cli(torch, kernels, cfg, spec, src, dev_params,
                            "magnitude",
                            os.path.join(tmp, "v4_magnitude.weights"),
                            "yolov4_voc")
    s_layer = len(spec.conv_indices()) + 1
    at = r.pop("launches_by_width")
    check(all(at[name] == {s_layer: n} for name, n in PRUNE_LAUNCHES.items()),
          f"yolov4_voc magnitude: launches by S {at}")
    widths["prune_magnitude_yolov4"] = at
    done("prune_magnitude", **r)
    topk = topk_case(torch, _topk_layout(torch, spec, dev_params, True,
                                         "random"), "random")
    emit({"phase": "families_train", "ok": True, "kernel": "topk",
          "card": card, **topk})
    del dev_params
    structured = (
        ("fpgm", ["--tied", "group", "--fraction", str(FILTER_FRACTION)]),
        ("bn_gamma", ["--target-flops", str(FLOP_TARGET)]),
        ("taylor", ["--tied", "group", "--fraction", str(FILTER_FRACTION),
                    "--data", data, "--score-batches", str(TAYLOR_BATCHES),
                    "--batch", str(TAYLOR_BATCH)]))
    for mode, extra in structured:
        out = os.path.join(tmp, f"v4_{mode}.weights")
        text, counts, at, secs = _run_cli(
            torch, kernels, prune.main,
            ["--cfg", cfg, "--weights", src, "--mode", mode, *extra,
             "--device", "cuda", "--out", out], f"prune --mode {mode}")
        expect_launches(kernels, counts, at, f"prune --mode {mode}", {}, {})
        slim = load_cfg(os.path.join(tmp, f"v4_{mode}.cfg"))
        slim_params, _ = load_weights(out, slim)
        check(_shortcuts_aligned(slim), f"prune {mode}: shortcut widths")
        tied = [i for g in tied_conv_groups(spec) for i in g]
        rr = {"mode": mode, "flags": extra, "cli_s": secs,
              "conv_gflop_per_img": {"before": spec_gflop(spec),
                                     "after": spec_gflop(slim)},
              "tied_convs_pruned": sum(slim.layers[i].filters
                                       < spec.layers[i].filters
                                       for i in tied),
              "served": drive_serving(torch, kernels, slim, slim_params,
                                      f"prune {mode}", want={})}
        if mode == "taylor":
            rr["card_vs_cpu"] = taylor_card_vs_cpu(torch, spec, params, data)
        else:
            rr["card_vs_cpu"], keep = structured_card_vs_cpu(
                torch, spec, params, mode)
            check(all(slim.layers[i].filters == len(k)
                      for i, k in keep.items()),
                  f"prune {mode}: the CLI's widths differ from the keep-sets")
        if mode == "bn_gamma":
            m = re.search(r"\(([0-9.]+) of base, target", text)
            check(m and float(m.group(1)) <= FLOP_TARGET,
                  f"prune bn_gamma: FLOP allocation line {m}")
            rr["flop_fraction"] = float(m.group(1))
        done(f"prune_{mode}", **rr)

    # (e) finetune --iterate on YOLOv4-VOC: magnitude (the top-k kernels at
    # S = 111 each round) and l1_filter --tied group (a repack each round,
    # shortcut adds aligned); no input stage in the evals
    base = ["--cfg", cfg, "--data", data, "--batch", str(BATCH),
            "--subdivisions", str(sub), "--device", "cuda", "--weights",
            src, "--steps", str(ITER_STEPS), "--iterate",
            ",".join(map(str, ITER_FRACTIONS))]
    r, widths["iterate_magnitude_yolov4"] = iterate_magnitude(
        torch, kernels, base, spec, tmp, "yolov4",
        forwards_want(spec, len(ITER_FRACTIONS) * n_batches))
    done("iterate_magnitude", **r)
    ck = os.path.join(tmp, "ck_l1_yolov4")
    _, counts, at, secs = _run_cli(
        torch, kernels, finetune.main,
        base + ["--iterate-mode", "l1_filter", "--tied", "group",
                "--ckpt-dir", ck, "--out",
                os.path.join(tmp, "v4_iter_l1.weights")],
        "finetune --iterate l1_filter --tied group")
    expect_launches(kernels, counts, at, "iterate l1_filter --tied group",
                    forwards_want(spec, len(ITER_FRACTIONS) * n_batches),
                    {})
    rounds = []
    for ridx, frac in enumerate(ITER_FRACTIONS):
        rspec, saved, meta = load_checkpoint(os.path.join(
            ck, f"step_{ridx:08d}"))
        check(_shortcuts_aligned(rspec), f"iterate round {ridx}: shortcut "
              "widths differ")
        groups = tied_conv_groups(spec)
        widths_g = [{rspec.layers[i].filters for i in g} for g in groups]
        check(all(len(w) == 1 for w in widths_g), f"iterate round {ridx}: "
              f"tied widths {widths_g}")
        rounds.append({"fraction": frac, "map50": meta["metrics"]["map50"],
                       "gflop_per_img": spec_gflop(rspec),
                       "tied_group_widths": [w.pop() for w in widths_g]})
    shutil.rmtree(ck)
    done("iterate_l1_tied_group", seconds=secs, rounds=rounds,
         launches=counts)
    emit({"phase": "families_train", "ok": True, "card": card,
          "seconds": time.perf_counter() - t_phase})
    return widths, topk


INT8_CALIB_IMAGES = 64
CALIB_QUANTILE = 0.999
INT8_AUTO_MIN_CHANNELS = 64
INT8_RAW_TOL = 1e-5      # card vs CPU raw maps, of the largest magnitude
V4_CALIB_IMAGES = 16
DETECT_QMODEL_IMAGES = 8


@contextlib.contextmanager
def recording_int8_convs(records):
    """Every int8 conv ``compress.quantize.forward_quantized`` runs inside,
    appended to ``records`` as (x_q, w_q, stride, padding, int32 sums)."""
    from modelcompression_tpu_torch.compress import quantize as tq
    real = tq.int8_conv

    def record(x_q, w_q, stride, padding):
        y = real(x_q, w_q, stride, padding)
        records.append((x_q, w_q, stride, padding, y))
        return y

    tq.int8_conv = record
    try:
        yield
    finally:
        tq.int8_conv = real


def _frames(torch, n, seed):
    import numpy as np
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n, SRC_H, SRC_W, 3), np.uint8))


@contextlib.contextmanager
def mish_on_cpu(torch):
    """``compress.quantize``'s activations with mish taken on the CPU for a
    card tensor (the devices' tanh and softplus differ by an ulp), every
    other activation as it is: the witness that this ulp alone makes the
    card's all-int8 YOLOv4 forward drift from the CPU's."""
    from modelcompression_tpu_torch.compress import quantize as tq
    real = tq._activate

    def activate(t, kind):
        if kind == "mish" and t.is_cuda:
            return real(t.cpu(), kind).to(t.device)
        return real(t, kind)

    tq._activate = activate
    try:
        yield
    finally:
        tq._activate = real


def _quantized_trace(spec, q, x):
    """``forward_quantized`` on the float NHWC canvas ``x``, one layer at a
    time through ``compress.quantize.quantized_layer``: every layer's
    output and scale, and the heads' raw maps."""
    from modelcompression_tpu_torch.compress.quantize import (
        head_map, quantized_layer,
    )
    from modelcompression_tpu_torch.models.cfg import YoloLayer
    outputs, scales, heads = [], [], []
    y, s = x.permute(0, 3, 1, 2), None
    for i, layer in enumerate(spec.layers):
        y, s = quantized_layer(q, spec, i, y, s, outputs, scales)
        if isinstance(layer, YoloLayer):
            heads.append(head_map(y, s))
        outputs.append(y)
        scales.append(s)
    return outputs, scales, heads or [head_map(y, s)]


def int8_layer_hold(torch, spec, q_cpu, x, outputs, scales, label):
    """Every layer of the card's int8 forward run again on the CPU on the
    card's own input to it (and the card's earlier outputs, for routes and
    shortcuts). An int8 conv's codes at most one step apart (its int32 sums
    are exact on both devices, so only the fp32 epilogue and the activation
    can move a code); a layer that only moves codes (maxpool, route, reorg,
    upsample) equal; a float map (shortcut, a route mixing grids, a head
    producer's raw map) within INT8_RAW_TOL of its largest; the scales
    equal. Returns the codes differing per int8 conv and the largest float
    error."""
    from modelcompression_tpu_torch.compress.quantize import quantized_layer
    from modelcompression_tpu_torch.models.cfg import ConvLayer
    outs = [o.cpu() for o in outputs]
    scs = [None if s is None else s.cpu() for s in scales]
    y, s = x.cpu().permute(0, 3, 1, 2), None
    per_conv, codes, float_rel = [], 0, 0.0
    for i, layer in enumerate(spec.layers):
        got, got_s = quantized_layer(q_cpu, spec, i, y, s, outs[:i], scs[:i])
        want, want_s = outs[i], scs[i]
        kind = f"{label}: layer {i} ({type(layer).__name__}) on the card's " \
            f"input, card vs CPU"
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{kind}: {got.dtype} {tuple(got.shape)} against "
              f"{want.dtype} {tuple(want.shape)}")
        check((got_s is None) == (want_s is None)
              and (want_s is None or torch.equal(got_s, want_s)),
              f"{kind}: scales {got_s} and {want_s}")
        if want_s is None:
            rel = _max_rel(want.float(), got.float())
            check(rel <= INT8_RAW_TOL, f"{kind}: {rel} of its largest "
                  f"(> {INT8_RAW_TOL})")
            float_rel = max(float_rel, rel)
        else:
            d = (want.int() - got.int()).abs()
            steps = int(d.max())
            if isinstance(layer, ConvLayer):
                check(steps <= 1, f"{kind}: {steps} steps apart")
                per_conv.append(int((d > 0).sum()))
                codes += d.numel()
            else:
                check(steps == 0, f"{kind}: moves codes {steps} steps")
        y, s = want, want_s
    return {"layers_held": len(spec.layers),
            "conv_codes_differing": sum(per_conv), "conv_codes": codes,
            "conv_codes_differing_share": sum(per_conv) / max(codes, 1),
            "conv_codes_differing_by_conv": per_conv,
            "float_max_err_over_max": float_rel}


def int8_end_to_end(torch, spec, q_cpu, int8_ids, recs, raw, ref, label,
                    hold):
    """The int8 forwards ``recs[label]`` / ``raw[label]`` against
    ``recs[ref]`` / ``raw[ref]`` (the CPU's) from the same canvas: every
    int8 conv's input codes, and each head's raw map. With ``hold``: codes
    at most one step apart, and each raw map within its head producer's
    bound: a one-step change of an input code moves an output by that
    tap's |w_q| grid steps, so |d| (*) |w_q| x in_scale x s_w (d the
    producer's input codes apart; 0 where none differ) plus INT8_RAW_TOL of
    the largest magnitude for the fp32 epilogue."""
    from modelcompression_tpu_torch.models import conv_key
    from modelcompression_tpu_torch.ops.int8_conv import int8_conv_plain
    steps, per_conv = 0, []
    for (a, *_), (b, *_) in zip(recs[label], recs[ref]):
        d = (a.cpu().int() - b.int()).abs()
        steps = max(steps, int(d.max()))
        per_conv.append(int((d > 0).sum()))
    n_diff = sum(per_conv)
    n_all = sum(r[0].numel() for r in recs[ref])
    rels, excess = [], []
    for h, got, want in zip(spec.head_indices(), raw[label], raw[ref]):
        rels.append(_max_rel(got, want))
        i = h - 1  # the head's producer conv, int8 in an all-int8 pytree
        k = int8_ids.index(i)
        x_a, x_b = recs[label][k][0].cpu(), recs[ref][k][0]
        p = q_cpu[conv_key(i)]
        d = (x_a.int() - x_b.int()).abs().clamp(max=127).to(torch.int8)
        moved = int8_conv_plain(d, p["w_q"].abs(), spec.layers[i].stride,
                                spec.layers[i].padding).double()
        allowed = moved * (p["in_scale"].double() * p["s_w"].double()) \
            + INT8_RAW_TOL * want.abs().max().double()
        over = (got.double() - want.double()).abs() / allowed
        excess.append(over.nan_to_num(nan=0.0, posinf=math.inf).max().item())
    if hold:
        check(steps <= 1, f"{label}: int8 activations against the CPU "
              f"{steps} steps apart")
        check(max(excess) <= 1, f"{label}: raw maps against the CPU "
              f"{rels} of their largest, {excess} of the bound a code "
              f"step allows")
    return {"codes_max_steps": steps, "codes_differing": n_diff,
            "codes": n_all, "codes_differing_share": n_diff / n_all,
            "first_differing_conv": next(
                (i for i, n in zip(int8_ids, per_conv) if n), None),
            "codes_differing_by_conv": per_conv,
            "raw_max_err_over_max_by_head": rels,
            "raw_err_over_bound_by_head": excess, "held": hold}


def int8_card_vs_cpu(torch, spec, qparams, label):
    """The all-int8 forward at batch 2 from one float canvas (two
    letterboxed frames, fp32), card against CPU, each int8 conv recorded.

    * Every int8 conv: the card's int32 sums bit-equal to the plain
      version's on the card for the same int8 input.
    * Every layer (``int8_layer_hold``): the card's forward traced one
      layer at a time (its heads equal to ``forward_quantized``'s) and
      each layer run on the CPU on the card's own input, so the
      shortcuts, SPP, upsamples and routes are held on the card too.
    * End to end (``int8_end_to_end``) against the CPU's forward: held for
      the card's own forward where the net has no mish; with mish (whose
      ulp moves a code, and a moved code moves the next conv's sums by up
      to 127 weight steps) held for the card's forward with mish taken on
      the CPU (``mish_on_cpu``), and the card's own drift reported."""
    from modelcompression_tpu_torch.compress import forward_quantized
    from modelcompression_tpu_torch.data.preprocess import letterbox_device
    from modelcompression_tpu_torch.models import conv_key, params_to
    from modelcompression_tpu_torch.ops.int8_conv import int8_conv_plain
    x = letterbox_device(_frames(torch, 2, SEED + 3), NET, NET)
    q = {dev: params_to(qparams, dev) for dev in ("cuda", "cpu")}
    int8_ids = [i for i in spec.conv_indices()
                if "w_q" in qparams[conv_key(i)]]
    mish = any(getattr(layer, "activation", None) == "mish"
               for layer in spec.layers)
    runs = {"cuda": ("cuda", contextlib.nullcontext()),
            "cpu": ("cpu", contextlib.nullcontext())}
    if mish:
        runs["cuda_mish_on_cpu"] = ("cuda", mish_on_cpu(torch))
    int8 = int8_counter()
    recs, raw = {}, {}
    for name, (dev, ctx) in runs.items():
        recs[name] = []
        int8.LAUNCHES = 0
        with torch.inference_mode(), ctx, recording_int8_convs(recs[name]):
            y = forward_quantized(q[dev], x.to(dev), spec)
        raw[name] = [t.float().cpu() for t in
                     (y if isinstance(y, tuple) else (y,))]
        if name == "cuda":
            torch.cuda.synchronize()
            card_launches = int8.LAUNCHES
    check(card_launches == len(recs["cuda"]) == len(recs["cpu"])
          == len(int8_ids), f"{label}: {card_launches} card int8 convs, "
          f"{len(recs['cuda'])} recorded, {len(int8_ids)} int8 convs in "
          f"the pytree")
    with torch.inference_mode():
        for i, (x_q, w_q, st, pad, y32) in zip(int8_ids, recs["cuda"]):
            check(torch.equal(int8_conv_plain(x_q, w_q, st, pad), y32),
                  f"{label}: int8 conv {i}: the card route's int32 sums "
                  f"differ from the plain version's")
        outputs, scales, heads = _quantized_trace(spec, q["cuda"], x.cuda())
        check(all(torch.equal(a.float().cpu(), b)
                  for a, b in zip(heads, raw["cuda"])),
              f"{label}: the layer-by-layer trace differs from "
              f"forward_quantized on the card")
        layers = int8_layer_hold(torch, spec, q["cpu"], x, outputs, scales,
                                 label)
        del outputs, scales, heads
        held = "cuda_mish_on_cpu" if mish else "cuda"
        ends = {name: int8_end_to_end(torch, spec, q["cpu"], int8_ids, recs,
                                      raw, "cpu", name, hold=name == held)
                for name in runs if name != "cpu"}
    return {"int8_convs": len(int8_ids),
            "int32_sums_bit_equal": len(recs["cuda"]),
            "layer_by_layer": layers, "forward": ends["cuda"],
            "forward_mish_on_cpu": ends.get("cuda_mish_on_cpu"),
            "end_to_end_held": held}


def quantile_select_case(torch, folded, spec, chunk):
    """The quantile route on one calibration chunk: every layer's |a| and
    the input's as one segment each, the two order statistics of
    ``jnp.quantile``'s interpolation found by the radix-select kernel and
    by its plain version on the same card tensors (equal), the thresholds
    equal either way; the select timed (CUDA events) beside its plain
    version, and its bound (bits and segment ids read once)."""
    from modelcompression_tpu_torch.utils.timing import time_fn
    import numpy as np
    from modelcompression_tpu_torch.compress import quantize as tq
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    with torch.inference_mode():
        x = torch.as_tensor(chunk, device="cuda")
        tensors = tq._calibration_outputs(folded, x, spec) + [x]
        bits, seg = tq._abs_bits_segments(tensors)
        sizes = [t.numel() for t in tensors]
        low, high, lw, hw = tq._quantile_positions(sizes, CALIB_QUANTILE)
        S = len(tensors)
        vals, err = {}, 0
        for name, k in (("low", low), ("high", high)):
            kk = torch.from_numpy(k).cuda()
            card = ct.radix_select_cuda(bits, seg, kk, S)
            plain = ct.radix_select_plain(bits, seg, kk, S)
            for a, b in zip(card, plain):
                check(torch.equal(a, b), f"quantile select ({name}): the "
                      f"radix kernel differs from its plain version")
                err = max(err, int((a - b).abs().max()))
            vals[name] = card[0].to(torch.int32).view(torch.float32).cpu() \
                .numpy()
        lo, hi = vals["low"], vals["high"]
        want = (hi.astype(np.float64) * hw.astype(np.float64)
                + (lo * lw).astype(np.float64)).astype(np.float32)
        got = tq.abs_quantiles(tensors, CALIB_QUANTILE)
        check(np.array_equal(got, want), "quantile thresholds differ from "
              "the plain computation's")
        kk = torch.from_numpy(low).cuda()
        ms = time_fn(lambda: ct.radix_select_cuda(bits, seg, kk, S),
                     iters=10, windows=1) * 1e3
        plain_ms = time_fn(lambda: ct.radix_select_plain(
            bits, seg, kk, S), iters=3, warmup=1, windows=1) * 1e3
        pass_ms = radix_pass_ms(torch, bits, seg, kk, S)
    n = bits.numel()
    # one select call: bits and segment ids read once (8 B an element);
    # each of its four histogram passes reads them again
    b = bound(8 * n, 0, PEAK_OPS_PER_S["float32"])
    return {"S": S, "n": n, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "pass_ms": pass_ms,
            "pass_bound_ms": b["bound_ms"],
            "four_pass_bound_ms": 4 * b["bound_ms"],
            "thresholds_equal_plain": True, **b}


def drive_int8_serving(torch, kernels, spec, qparams, label):
    """The serving step of phase 4 (batch 64, 384x512 frames, device
    letterbox, the deployment NMS) with ``forward_fn=forward_quantized`` on
    an int8 pytree: one step with every count at 0 (no hand-written kernel
    launches: the int8 forward has no fused input stage; the int8 conv's
    card route once per int8 conv), outputs finite in the stated shapes,
    then ms per batch from CUDA events, peak memory, a profiler window and
    the int8 conv's share of device time (its GEMM alone, and with the
    im2col and padding copies)."""
    from modelcompression_tpu_torch.utils.timing import time_fn
    from modelcompression_tpu_torch.cli._profiling import profile_window
    from modelcompression_tpu_torch.compress import forward_quantized
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models import num_conv_flops, params_to
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    images = torch.randint(0, 256, (BATCH, SRC_H, SRC_W, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    img_w = torch.full((BATCH,), float(SRC_W), device="cuda")
    img_h = torch.full((BATCH,), float(SRC_H), device="cuda")
    cfg = EvalConfig(conf_thresh=0.01, max_detections=32, nms_prefilter=128,
                     precision=FAST, device="cuda",
                     forward_fn=forward_quantized)
    q = params_to(qparams, "cuda")
    step = make_eval_step(spec, cfg, src_hw=(SRC_H, SRC_W))
    n_int8 = sum("w_q" in p for p in q.values())
    int8 = int8_counter()
    reset_counts(kernels)
    int8.LAUNCHES = 0
    int8.LAUNCHES_AT.clear()
    outs = step(q, images, img_w, img_h)
    torch.cuda.synchronize()
    counts, at = read_counts(kernels), read_widths(kernels)
    check(not any(counts.values()), f"{label}: kernel launches {counts} on "
          "the int8 serving path")
    check(int8.LAUNCHES == n_int8, f"{label}: {int8.LAUNCHES} int8 convs "
          f"on the card, {n_int8} in the pytree")
    c, k = spec.classes, cfg.max_detections
    shapes = [(BATCH, c, k, 4), (BATCH, c, k), (BATCH, c, k), (BATCH, c),
              (BATCH,)]
    check([tuple(o.shape) for o in outs] == shapes,
          f"{label}: output shapes {[tuple(o.shape) for o in outs]}")
    check(all(torch.isfinite(o.float()).all().item() for o in outs[:2]),
          f"{label}: non-finite outputs")
    n_valid = int(outs[2].sum().item())
    by_width = dict(int8.LAUNCHES_AT)
    torch.cuda.reset_peak_memory_stats()
    ms = time_fn(lambda: step(q, images, img_w, img_h), iters=10,
                 windows=1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof, _ = profile_window(lambda: step(q, images, img_w, img_h), steps=2)
    return {"model": label, "int8_convs": n_int8,
            "float_convs": len(spec.conv_indices()) - n_int8,
            "ms_per_batch": ms, "img_per_s": BATCH / ms * 1e3,
            "peak_gib": peak, "conv_gflop_per_img": num_conv_flops(spec) / 1e9,
            "launches": counts, "launches_by_width": at,
            "int8_conv_launches": n_int8,
            "int8_conv_launches_by_cout": by_width,
            "valid_detections": n_valid, "profile": prof,
            "int8_conv_device": int8_conv_share(
                torch, lambda: step(q, images, img_w, img_h))}


def int8_conv_share(torch, fn, steps=2):
    """A profiler window over ``steps`` calls with every int8 conv inside a
    ``record_function`` range: the device time of the int8 GEMMs
    (``aten::_int_mm``) and of the whole conv (GEMM, im2col and padding),
    each over the device time of all kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from modelcompression_tpu_torch.compress import quantize as tq
    real = tq.int8_conv

    def annotated(*a):
        with record_function("int8_conv"):
            return real(*a)

    tq.int8_conv = annotated
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
    finally:
        tq.int8_conv = real
    rows = prof.key_averages()
    busy = sum(e.device_time_total for e in rows
               if e.device_type == DeviceType.CUDA and e.key != "int8_conv")

    def cpu_row(key):
        return max((e.device_time_total for e in rows if e.key == key
                    and e.device_type == DeviceType.CPU), default=0.0)

    conv, gemm = cpu_row("int8_conv"), cpu_row("aten::_int_mm")
    return {"busy_ms_per_step": busy / steps / 1e3,
            "int8_conv_ms_per_step": conv / steps / 1e3,
            "int8_gemm_ms_per_step": gemm / steps / 1e3,
            "int8_conv_share": conv / busy if busy else 0.0,
            "int8_gemm_share": gemm / busy if busy else 0.0}


def _summary_lines(out):
    """An eval summary without its throughput figures."""
    return [re.sub(r"\s*\[.*img/s.*\]", "", ln) for ln in out.splitlines()
            if not ln.startswith(("throughput", "wrote"))]


def phase_int8(torch, kernels, card, tmp, data, weights, bf16):
    """Phase 11 (module docstring): PTQ of YOLOv2-VOC, int8 serving of the
    unpruned and the pruned model beside phase 4's bf16 steps (``bf16``:
    their phase lines), the int8 CLIs, YOLOv4-VOC all-int8, and the QAT
    fine-tune. Returns each path's launches by width."""
    from modelcompression_tpu_torch.cli import detect
    from modelcompression_tpu_torch.cli import eval as eval_cli
    from modelcompression_tpu_torch.cli import finetune
    from modelcompression_tpu_torch.cli.common import prep_calibration
    from modelcompression_tpu_torch.compress import (
        collect_act_absmax, forward_quantized, int8_layers_auto,
        qat_spec_from_batches, quantize_from_batches, quantize_network,
        repack, uniform_filter_fraction_keep_sets,
    )
    from modelcompression_tpu_torch.data import (
        load_list_dataset, read_data_cfg,
    )
    from modelcompression_tpu_torch.data.preprocess import (
        letterbox_device, quantize_canvas,
    )
    from modelcompression_tpu_torch.models import (
        cfg_path, fold_batchnorm, init_params, load_cfg, load_weights,
        params_to,
    )
    import numpy as np
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    params, _ = load_weights(weights, spec)  # phase 6's, from seed 0
    samples = load_list_dataset(read_data_cfg(data)["valid"])
    widths = {}
    int8 = int8_counter()

    t_part = [time.perf_counter()]

    def done(part, **kw):
        now = time.perf_counter()
        emit({"phase": "int8", "part": part, "ok": True, "card": card,
              "part_s": now - t_part[0], **kw})
        t_part[0] = now

    # (a) PTQ of YOLOv2-VOC 416 at full width
    _, chunks, n_cal = prep_calibration(spec, samples, INT8_CALIB_IMAGES,
                                        "all")
    folded = params_to(fold_batchnorm(params, spec), "cuda")
    reset_counts(kernels)
    t0 = time.perf_counter()
    absmax, in_max = collect_act_absmax(folded, spec, chunks)
    torch.cuda.synchronize()
    absmax_s = time.perf_counter() - t0
    q_all = quantize_network(folded, spec, absmax, in_max)
    check(not any(read_counts(kernels).values()),
          "absmax calibration launched a kernel")
    reset_counts(kernels)
    t0 = time.perf_counter()
    qmax, q_in = collect_act_absmax(folded, spec, chunks,
                                    quantile=CALIB_QUANTILE)
    torch.cuda.synchronize()
    quantile_s = time.perf_counter() - t0
    counts, at = read_counts(kernels), read_widths(kernels)
    widths["quantile_calibration"] = at
    S = len(spec.layers) + 1
    expect_launches(kernels, counts, at, "quantile calibration",
                    {"topk_radix_select": 2 * SELECT_LAUNCHES * len(chunks)},
                    {"topk_radix_select":
                     {S: 2 * SELECT_LAUNCHES * len(chunks)}})
    check(np.all(qmax > 0) and np.all(qmax <= absmax * (1 + 1e-6))
          and 0 < q_in <= in_max * (1 + 1e-6),
          "quantile thresholds not in (0, absmax]")
    select = quantile_select_case(torch, folded, spec, chunks[0])
    select["launches"] = counts["topk_radix_select"]
    cvc = int8_card_vs_cpu(torch, spec, q_all, "yolov2_voc")
    # the int8-input canvas on the card: bit-equal to the float canvas
    # followed by the forward's quantize, and the forward alike
    frames = _frames(torch, 2, SEED + 4).cuda()
    qs = q_all["__net__"]["input_scale"].cuda()
    q_dev = params_to(q_all, "cuda")
    with torch.inference_mode():
        xf = letterbox_device(frames, NET, NET, dtype=torch.bfloat16)
        x8 = letterbox_device(frames, NET, NET, dtype=torch.bfloat16,
                              quant_scale=qs)
        check(x8.dtype == torch.int8
              and torch.equal(x8, quantize_canvas(xf, qs)),
              "the int8 canvas differs from the quantized float canvas")
        check(torch.equal(forward_quantized(q_dev, x8, spec),
                          forward_quantized(q_dev, xf, spec)),
              "the int8-input forward differs from the float canvas's")
    done("ptq_yolov2", calibration_images=n_cal, chunks=len(chunks),
         absmax_calibration_s=absmax_s, quantile=CALIB_QUANTILE,
         quantile_calibration_s=quantile_s,
         quantile_over_absmax=[float(a) for a in qmax / np.maximum(
             absmax, 1e-30)],
         quantile_select=select, card_vs_cpu=cvc,
         int8_canvas_bit_equal=True)

    # (b) serving at batch 64: unpruned all-int8, 75%-pruned hybrid
    keep = uniform_filter_fraction_keep_sets(spec, params, PRUNE_FRACTION)
    pspec, pparams = repack(spec, params, keep)
    sel = int8_layers_auto(pspec, min_channels=INT8_AUTO_MIN_CHANNELS)
    # the same canvases: calibration depends on the net size only
    q_pruned = quantize_from_batches(
        params_to(fold_batchnorm(pparams, pspec), "cuda"), pspec, chunks,
        int8_layers=sel)
    for label, s_, q_ in (("unpruned_int8", spec, q_all),
                          ("pruned_int8", pspec, q_pruned)):
        r = drive_int8_serving(torch, kernels, s_, q_, label)
        base = "unpruned" if label == "unpruned_int8" else "pruned75"
        r["bf16_phase4"] = {k: bf16[base][k] for k in
                            ("ms_per_batch", "img_per_s", "peak_gib")}
        r["int8_over_bf16_ms"] = r["ms_per_batch"] / \
            bf16[base]["ms_per_batch"]
        widths[label] = r["launches_by_width"]
        done("serving", int8_layers="all" if label == "unpruned_int8"
             else f"auto:{INT8_AUTO_MIN_CHANNELS} {sel}", **r)

    # (c) the CLIs: eval --int8 --save-qmodel, eval --qmodel, detect
    # --qmodel --dir, the serve daemon with --qmodel
    qpath = os.path.join(tmp, "yolov2-voc-int8.npz")
    n_batches = -(-EVAL_IMAGES // BATCH)
    n_int8 = len(spec.conv_indices())
    base = ["--cfg", cfg, "--data", data, "--batch", str(BATCH),
            "--device", "cuda"]
    int8.LAUNCHES = 0
    out_i, counts, at, secs_i = _run_cli(
        torch, kernels, eval_cli.main,
        base + ["--weights", weights, "--int8", "--save-qmodel", qpath],
        "eval --int8 --save-qmodel")
    widths["eval_int8"] = at
    expect_launches(kernels, counts, at, "eval --int8", {}, {})
    check(int8.LAUNCHES == n_batches * n_int8,
          f"eval --int8: {int8.LAUNCHES} int8 convs")
    int8.LAUNCHES = 0
    out_q, counts, at, secs_q = _run_cli(
        torch, kernels, eval_cli.main, base + ["--qmodel", qpath],
        "eval --qmodel")
    widths["eval_qmodel"] = at
    expect_launches(kernels, counts, at, "eval --qmodel", {}, {})
    check(int8.LAUNCHES == n_batches * n_int8,
          f"eval --qmodel: {int8.LAUNCHES} int8 convs")
    check(_summary_lines(out_q) == _summary_lines(out_i),
          "eval --qmodel's summary differs from eval --int8's")
    listed = read_data_cfg(data)
    with open(listed["valid"]) as f:
        paths = f.read().split()
    det_dir = os.path.join(tmp, "detect_in")
    os.makedirs(det_dir, exist_ok=True)
    for p in paths[:DETECT_QMODEL_IMAGES]:
        shutil.copy(p, det_dir)
    out_d, counts, at, secs_d = _run_cli(
        torch, kernels, detect.main,
        ["--cfg", cfg, "--qmodel", qpath, "--dir", det_dir, "--out-dir",
         os.path.join(tmp, "detect_out"), "--batch", str(DETECT_QMODEL_IMAGES),
         "--device", "cuda", "--deployment"], "detect --qmodel --dir")
    widths["detect_qmodel"] = at
    expect_launches(kernels, counts, at, "detect --qmodel", {}, {})
    widths["server_qmodel"] = phase_server(
        torch, kernels, card, extra=["--qmodel", qpath], want={},
        label="yolov2_voc_int8", phase="int8_server", int8_convs=n_int8)
    done("clis", eval_int8_s=secs_i, eval_qmodel_s=secs_q,
         detect_s=secs_d, map50=_map_line(out_i)[0],
         summaries_equal=True, artifact_bytes=os.path.getsize(qpath),
         weights_bytes=os.path.getsize(weights))

    # (d) YOLOv4-VOC 416 all-int8: card vs CPU per head, served at 64
    v4 = load_cfg(cfg_path(FAMILY_CFG))
    v4_params = init_params(v4, seed=SEED)
    _, v4_chunks, _ = prep_calibration(v4, samples, V4_CALIB_IMAGES, "all")
    t0 = time.perf_counter()
    q_v4 = quantize_from_batches(
        params_to(fold_batchnorm(v4_params, v4), "cuda"), v4, v4_chunks)
    torch.cuda.synchronize()
    v4_cal_s = time.perf_counter() - t0
    v4_cvc = int8_card_vs_cpu(torch, v4, q_v4, "yolov4_voc")
    r = drive_int8_serving(torch, kernels, v4, q_v4, "yolov4_voc_int8")
    widths["yolov4_voc_int8"] = r["launches_by_width"]
    done("yolov4_voc", calibration_s=v4_cal_s, card_vs_cpu=v4_cvc,
         served=r)

    # (e) finetune --qat --save-qmodel on YOLOv2-VOC, the cfg's batch and
    # subdivisions, FAST
    qat_q = os.path.join(tmp, "qat.npz")
    log = os.path.join(tmp, "qat.jsonl")
    int8.LAUNCHES = 0
    out_f, counts, at, secs_f = _run_cli(
        torch, kernels, finetune.main,
        ["--cfg", cfg, "--data", data, "--batch", str(BATCH),
         "--subdivisions", str(spec.net.subdivisions), "--device", "cuda",
         "--weights", weights, "--steps", str(FT_STEPS), "--qat",
         "--save-qmodel", qat_q, "--out", os.path.join(tmp, "qat.weights"),
         "--log-jsonl", log], "finetune --qat --save-qmodel")
    widths["finetune_qat"] = at
    c1 = spec.layers[0].filters
    expect_launches(kernels, counts, at, "finetune --qat",
                    forwards_want(spec, n_batches),
                    {"input_stage_mma": {c1: n_batches}})
    check(int8.LAUNCHES == n_batches * n_int8,
          f"finetune --qat: {int8.LAUNCHES} int8 convs in the int8 eval")
    losses = [rec["loss"] for rec in _read_jsonl(log)]
    check(losses and all(math.isfinite(v) for v in losses),
          f"finetune --qat: logged losses {losses}")
    int8_part = out_f.split("int8 deployment (QAT grids):")
    check(len(int8_part) == 2, "finetune --qat printed no int8 summary")
    ft_map = _map_line(int8_part[1])[0]
    out_e, _, _, _ = _run_cli(torch, kernels, eval_cli.main,
                              base + ["--qmodel", qat_q],
                              "eval --qmodel (QAT export)")
    check(_map_line(out_e)[0] == ft_map, f"eval --qmodel of the QAT export: "
          f"mAP {_map_line(out_e)[0]}, finetune printed {ft_map}")
    plan = qat_spec_from_batches(params_to(params, "cuda"), spec,
                                 chunks[:1])
    sub = spec.net.subdivisions
    timing = [train_step_timing(torch, spec, params, sub, qat=qat, timed=3)
              for qat in (None, plan, plan, None)]
    done("qat", finetune_s=secs_f, losses=losses, float_map50=_map_line(
        int8_part[0])[0], int8_map50=ft_map, qmodel_map_equal=True,
        step_ms={"plain": [timing[0]["step_ms"], timing[3]["step_ms"]],
                 "qat": [timing[1]["step_ms"], timing[2]["step_ms"]]},
        peak_gib={"plain": timing[0]["max_memory_allocated_gib"],
                  "qat": timing[1]["max_memory_allocated_gib"]})
    return widths, select


# phase 12: the compression axes on YOLOv2-VOC 416
GMP_FINAL = 0.75
GMP_STEPS = 3  # steps 0, 1, 2: a recompute at each (begin 0, end 2)
LAMP_SPARSITY = 0.75
DISTILL_STEPS = 3
STUDENT_FRACTION = 0.75
LOWRANK_ENERGY = 0.9
FP32_RTOL = 1e-4  # PERF.md section 2: fp32 forwards, max rel
CLUSTER_BITS = 6
DECODE_LAYER = "conv2"  # 18,432 codes: the pure-Python decoder's layer
QAT_PACK_STEPS = 1


@contextlib.contextmanager
def plain_topk():
    """Inside, ``prune_flat`` runs the plain versions of its three kernels
    on the same (CUDA) tensors: what a path's kernels are held against.
    Nothing launches inside."""
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    saved = ct.radix_select, ct.tie_counts, ct.apply_threshold
    ct.radix_select = ct.radix_select_plain
    ct.tie_counts = ct.tie_counts_plain
    ct.apply_threshold = ct.apply_threshold_plain
    try:
        yield
    finally:
        ct.radix_select, ct.tie_counts, ct.apply_threshold = saved


@contextlib.contextmanager
def gmp_recorder(torch, records):
    """Inside, every GMP mask recompute (``compress.gmp.gmp_masks``, run by
    the train step on a due step) is timed (synchronized) and held equal
    to the same recompute through the kernels' plain versions on the same
    weights; each due step's updated masks must hold at least floor(f32(s)
    * f32(n)) zeros a segment (more only in exact-zero ties). ``records``
    gets one dict per due step."""
    from modelcompression_tpu_torch.compress import gmp
    from modelcompression_tpu_torch.train import train_step as ts
    orig_masks, orig_update = gmp.gmp_masks, ts.gmp_mask_update

    def masks(params, net, sparsity, per_layer=True, skip=()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = orig_masks(params, net, sparsity, per_layer, skip)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with plain_topk():
            want = orig_masks(params, net, sparsity, per_layer, skip)
        for k, m in want.items():
            check(torch.equal(got[k], m), f"gmp at s={float(sparsity)}: "
                  f"the mask of {k} differs from prune_flat's plain "
                  "version on the same weights")
        records.append({"sparsity": float(sparsity), "recompute_ms": ms,
                        "plain_equal": True})
        return got

    def update(g, net, trainable, old, step, shards=None):
        out = orig_update(g, net, trainable, old, step, shards=shards)
        if gmp.gmp_due(g, step):
            keys = list(old)
            zeros = [int((~out[k]).sum()) for k in keys]
            want = gmp.gmp_zero_counts([out[k].numel() for k in keys],
                                       gmp.gmp_sparsity(step, g),
                                       g.per_layer)
            got = zeros if g.per_layer else [sum(zeros)]
            check(all(a >= b for a, b in zip(got, want)),
                  f"gmp step {step}: zeros {got} below floor(s n) {want}")
            records[-1].update(step=int(step), zeros=sum(zeros),
                               floor_zeros=sum(want), exact=got == want)
        return out

    gmp.gmp_masks, ts.gmp_mask_update = masks, update
    try:
        yield
    finally:
        gmp.gmp_masks, ts.gmp_mask_update = orig_masks, orig_update


def _in_turns(timing):
    """(a, b, b, a) step timings -> {"plain": [a, a], "with": [b, b]}."""
    return {"plain": [timing[0]["step_ms"], timing[3]["step_ms"]],
            "with": [timing[1]["step_ms"], timing[2]["step_ms"]]}


def _frames_on_card(torch, n=2):
    """``n`` random 384x512 frames letterboxed to 416 on the card (fp32
    NHWC in [0, 1])."""
    import numpy as np
    from modelcompression_tpu_torch.data.preprocess import letterbox_device
    frames = np.random.default_rng(SEED).integers(
        0, 256, (n, SRC_H, SRC_W, 3), np.uint8)
    return letterbox_device(torch.as_tensor(frames, device="cuda"), NET, NET)


def phase_compress(torch, kernels, card, tmp, data, weights, bf16):
    """Phase 12 (module docstring): GMP, LAMP, distillation, low-rank,
    weight sharing and packing on full-width YOLOv2-VOC 416 (phase 6's
    weights and magnitude-pruned weights, phase 7's fixture; ``bf16``:
    phase 4's serving lines). Returns each path's launches by width."""
    from modelcompression_tpu_torch.utils.timing import time_fn
    import numpy as np
    from modelcompression_tpu_torch.cli import detect
    from modelcompression_tpu_torch.cli import eval as eval_cli
    from modelcompression_tpu_torch.cli import finetune, prune
    from modelcompression_tpu_torch.compress import (
        GMPSpec, factor_network, lamp, load_cmodel, load_qmodel,
    )
    from modelcompression_tpu_torch.compress import packing
    from modelcompression_tpu_torch.core.precision import BITMATCH, FAST
    from modelcompression_tpu_torch.data import read_data_cfg
    from modelcompression_tpu_torch.models import (
        cfg_path, fold_batchnorm, forward_folded, load_cfg, load_weights,
        params_to,
    )
    from modelcompression_tpu_torch.native import load_huffcodec
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    from modelcompression_tpu_torch.ops import input_stage_match
    from modelcompression_tpu_torch.train import (
        detection_distill_loss, make_distill_plan,
    )
    from modelcompression_tpu_torch.train.distill import teacher_forward
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    params, _ = load_weights(weights, spec)  # phase 6's, from seed 0
    dev_params = params_to(params, "cuda")
    n_batches = -(-EVAL_IMAGES // BATCH)
    sub = spec.net.subdivisions
    c1 = spec.layers[0].filters
    s_layer = len(spec.conv_indices()) + 1  # + the padding segment
    base = ["--data", data, "--batch", str(BATCH), "--subdivisions",
            str(sub), "--device", "cuda"]
    widths = {}
    t_part = [time.perf_counter()]

    def done(part, **kw):
        now = time.perf_counter()
        emit({"phase": "compress", "part": part, "ok": True, "card": card,
              "part_s": now - t_part[0], **kw})
        t_part[0] = now

    def out_path(name):
        return os.path.join(tmp, name)

    # (a) GMP inside the train step, per layer (S=24) and global (S=2)
    runs = {}
    for mode, extra, S in (("per_layer", [], s_layer),
                           ("global", ["--gmp-global"], 2)):
        records = []
        log = out_path(f"gmp_{mode}.jsonl")
        label = f"finetune --gmp ({mode})"
        with gmp_recorder(torch, records):
            out, counts, at, secs = _run_cli(
                torch, kernels, finetune.main,
                ["--cfg", cfg, *base, "--weights", weights, "--steps",
                 str(GMP_STEPS), "--gmp", str(GMP_FINAL), "--gmp-begin", "0",
                 "--gmp-end", str(GMP_STEPS - 1), "--gmp-freq", "1", *extra,
                 "--out", out_path(f"gmp_{mode}.weights"), "--log-jsonl",
                 log], label)
        widths[f"gmp_{mode}"] = at
        prune_want = {n: GMP_STEPS * k for n, k in PRUNE_LAUNCHES.items()}
        expect_launches(kernels, counts, at, label,
                        dict(prune_want, **forwards_want(spec, n_batches)),
                        dict({n: {S: k} for n, k in prune_want.items()},
                             input_stage_mma={c1: n_batches}))
        check(len(records) == GMP_STEPS
              and all("step" in r for r in records),
              f"{label}: {len(records)} recomputes recorded")
        check("gmp: final sparsity" in out, f"{label}: no final line")
        log_recs = _read_jsonl(log)
        check(log_recs and all(math.isfinite(r["loss"]) for r in log_recs),
              f"{label}: losses {[r['loss'] for r in log_recs]}")
        written, _ = load_weights(out_path(f"gmp_{mode}.weights"), spec)
        n_w = sum(p["w"].numel() for p in written.values())
        z_w = sum(int((p["w"] == 0).sum()) for p in written.values())
        check(z_w >= records[-1]["floor_zeros"],
              f"{label}: {z_w} zero weights written, below "
              f"{records[-1]['floor_zeros']}")
        runs[mode] = {"segments": S, "seconds": secs, "due_steps": records,
                      "sparsity_metric": log_recs[-1]["sparsity"],
                      "written_zero_share": z_w / n_w, "launches": counts,
                      "launches_by_width": at}
    g_every = GMPSpec(final_sparsity=GMP_FINAL, begin=0, end=10 ** 6,
                      frequency=1)
    timing = [train_step_timing(torch, spec, params, sub, gmp=g, timed=3)
              for g in (None, g_every, g_every, None)]
    done("gmp", runs=runs, step_ms=_in_turns(timing),
         step_note="the GMP step recomputes its masks every step (a due "
                   "step each)")

    # (b) LAMP: the prune CLI, its cut held against the stable-argsort
    # rank on the card, then the iterate mode
    label = "prune --mode lamp"
    lamp_out = out_path("lamp.weights")
    out, counts, at, secs = _run_cli(
        torch, kernels, prune.main,
        ["--cfg", cfg, "--weights", weights, "--mode", "lamp", "--sparsity",
         str(LAMP_SPARSITY), "--device", "cuda", "--out", lamp_out], label)
    widths["prune_lamp"] = at
    expect_launches(kernels, counts, at, label, PRUNE_LAUNCHES,
                    {n: {2: k} for n, k in PRUNE_LAUNCHES.items()})
    keys = lamp._keys(spec, ())
    with torch.no_grad():
        cat, sizes = lamp._scores_layout(dev_params, keys)
    n = sum(sizes)
    n_zero = int(LAMP_SPARSITY * n)
    seg = ct._seg_ids_for(sizes, cat.numel(), False, 1, cat.device)
    nz = torch.tensor([n_zero, 0], device="cuda")
    got = ct.prune_flat(cat, seg, nz, 2, return_mask=True)[:n] != 0
    check(torch.equal(got, lamp.lamp_cut_plain(cat[:n], n_zero)),
          "lamp: the cut through the kernels differs from the stable-"
          "argsort rank on the same scores")
    check(int((~got).sum()) == n_zero, "lamp: zero count")
    masks = lamp.lamp_masks(dev_params, spec, LAMP_SPARSITY)
    written, _ = load_weights(lamp_out, spec)
    for k, m in masks.items():
        w = written[k]["w"].to("cuda")
        check(torch.equal(w[m], dev_params[k]["w"][m]) and not w[~m].any(),
              f"{label}: the written weights of {k} are not the masked "
              "params")
    alloc = lamp.lamp_layer_sparsities(masks)
    lamp_ms = time_fn(lambda: lamp.lamp_masks(
        dev_params, spec, LAMP_SPARSITY), iters=3, warmup=1, windows=1) * 1e3
    with plain_topk():
        lamp_plain_ms = time_fn(lambda: lamp.lamp_masks(
            dev_params, spec, LAMP_SPARSITY), iters=2, warmup=1,
            windows=1) * 1e3
    cut_ms = time_fn(lambda: ct.prune_flat(cat, seg, nz, 2,
                                           return_mask=True),
                     iters=5, windows=1) * 1e3
    cut_plain_ms = time_fn(lambda: lamp.lamp_cut_plain(
        cat[:n], n_zero), iters=2, warmup=1, windows=1) * 1e3
    del cat, seg, got
    label = "finetune --iterate lamp"
    out, counts, at, secs_it = _run_cli(
        torch, kernels, finetune.main,
        ["--cfg", cfg, *base, "--weights", weights, "--steps",
         str(ITER_STEPS), "--iterate", ",".join(map(str, ITER_FRACTIONS)),
         "--iterate-mode", "lamp", "--out", out_path("lamp_it.weights")],
        label)
    widths["iterate_lamp"] = at
    n_r = len(ITER_FRACTIONS)
    prune_want = {n_: n_r * k for n_, k in PRUNE_LAUNCHES.items()}
    expect_launches(kernels, counts, at, label,
                    dict(prune_want, **forwards_want(spec, n_r * n_batches)),
                    dict({n_: {2: k} for n_, k in prune_want.items()},
                         input_stage_mma={c1: n_r * n_batches}))
    it_w, _ = load_weights(out_path("lamp_it.weights"), spec)
    it_zero = sum(int((p["w"] == 0).sum()) for p in it_w.values())
    check(it_zero >= int(ITER_FRACTIONS[-1] * n),
          f"{label}: {it_zero} zero weights, below the last round's cut")
    done("lamp", weights=n, zeros=n_zero, masks_equal_plain=True,
         cli_s=secs, lamp_masks_ms=lamp_ms, lamp_masks_plain_ms=lamp_plain_ms,
         cut_ms=cut_ms, cut_plain_ms=cut_plain_ms,
         allocation={"min": min(alloc.values()), "max": max(alloc.values()),
                     "by_layer": alloc},
         iterate={"seconds": secs_it, "zero_weights": it_zero,
                  "launches": counts})

    # (c) distillation: a 75%-L1-pruned, repacked student from the
    # unpruned teacher (phase 6's weights)
    student_w, student_cfg = out_path("student.weights"), \
        out_path("student.cfg")
    _run_cli(torch, kernels, prune.main,
             ["--cfg", cfg, "--weights", weights, "--mode", "l1_filter",
              "--fraction", str(STUDENT_FRACTION), "--device", "cuda",
              "--out", student_w, "--out-cfg", student_cfg],
             "prune --mode l1_filter (the student)")
    s_spec = load_cfg(student_cfg)
    s_c1 = s_spec.layers[0].filters
    log = out_path("distill.jsonl")
    label = "finetune --distill"
    out, counts, at, secs = _run_cli(
        torch, kernels, finetune.main,
        ["--cfg", student_cfg, *base, "--weights", student_w, "--steps",
         str(DISTILL_STEPS), "--distill", weights, "--distill-cfg", cfg,
         "--out", out_path("distilled.weights"), "--log-jsonl", log], label)
    widths["finetune_distill"] = at
    # the student's eval, and the teacher's forward once a step (no
    # gradient, bf16, without the input stage)
    want = forwards_want(s_spec, n_batches)
    want[EPILOGUE] += DISTILL_STEPS * epilogue_convs(spec, fused=False)
    expect_launches(kernels, counts, at, label, want,
                    {"input_stage_mma": {s_c1: n_batches}})
    log_recs = _read_jsonl(log)
    check(log_recs and all(math.isfinite(r["loss_distill"])
                           and r["loss_distill"] > 0 for r in log_recs),
          f"{label}: loss_distill {[r.get('loss_distill') for r in log_recs]}")
    plan = make_distill_plan(dev_params, spec, spec)
    x = _frames_on_card(torch, 8)
    t_raw = teacher_forward(plan, plan.teacher_params, x, FAST)
    zero = float(detection_distill_loss(t_raw, t_raw, spec))
    check(zero == 0.0, f"distill loss of the teacher against itself {zero}")
    s_params, _ = load_weights(student_w, s_spec)
    plan_s = make_distill_plan(dev_params, spec, s_spec)
    timing = [train_step_timing(torch, s_spec, s_params, sub, distill=d,
                                timed=3)
              for d in (None, plan_s, plan_s, None)]
    done("distill", student_conv1=s_c1, seconds=secs,
         loss_distill=[r["loss_distill"] for r in log_recs],
         loss=[r["loss"] for r in log_recs], self_loss=zero,
         map50=_map_line(out)[0], step_ms=_in_turns(timing))
    del plan, plan_s, t_raw

    # (d) low-rank: the prune CLI at energy 0.9, the factored model
    # served; every conv at full rank, its fp32 forward against the
    # original's
    label = "prune --mode lowrank"
    out, counts, at, secs = _run_cli(
        torch, kernels, prune.main,
        ["--cfg", cfg, "--weights", weights, "--mode", "lowrank",
         "--energy", str(LOWRANK_ENERGY), "--device", "cuda", "--out",
         out_path("lowrank.weights")], label)
    expect_launches(kernels, counts, at, label, {}, {})
    m = re.search(r"lowrank: factored (\d+) convs", out)
    check(m, f"{label}: no report line")
    f_spec = load_cfg(out_path("lowrank.cfg"))
    f_params, _ = load_weights(out_path("lowrank.weights"), f_spec)
    served = drive_serving(torch, kernels, f_spec, f_params, "lowrank",
                           want=None if input_stage_match(f_spec) else {})
    widths["lowrank_served"] = served["launches_by_width"]
    t0 = time.perf_counter()
    full_spec, full_params, report = factor_network(
        params, spec, energy=1.0, max_cost=1e9)
    full_s = time.perf_counter() - t0
    check(len(report) == len(spec.conv_indices()),
          f"full rank: {len(report)} of {len(spec.conv_indices())} convs "
          "factored")
    x = _frames_on_card(torch, 2)
    BITMATCH.apply_backend_flags()
    with torch.inference_mode():
        y0 = forward_folded(params_to(fold_batchnorm(params, spec), "cuda"),
                            x, spec, BITMATCH)
        y1 = forward_folded(params_to(fold_batchnorm(full_params, full_spec),
                                      "cuda"), x, full_spec, BITMATCH)
        rel = ((y1 - y0).abs().max() / y0.abs().max()).item()
    check(rel <= FP32_RTOL, f"full-rank factored fp32 forward: max rel "
          f"{rel} > {FP32_RTOL}")
    done("lowrank", energy=LOWRANK_ENERGY, host_s=secs,
         factored_convs=int(m.group(1)), params_line=[
             ln for ln in out.splitlines() if ln.startswith("lowrank:")],
         served=served,
         unfactored_img_per_s=bf16["unpruned"]["img_per_s"],
         full_rank={"convs": len(report), "host_s": full_s,
                    "ranks_below_full": sum(e.rank < e.full_rank
                                            for e in report),
                    "fp32_max_rel": rel})
    del full_params, y0, y1

    # (e) weight sharing and packing on phase 6's 75%-magnitude-pruned
    # weights: eval --cluster-bits --save-cmodel --pack, the artifact
    # served (its raw maps bit-equal to the reconstructed params'), the
    # native codec, and the packed int8 artifact of finetune --qat
    pruned = out_path("magnitude.weights")
    cpath = out_path("yolov2-voc-c6.npz")
    captured = {}
    orig_reconstruct = eval_cli.reconstruct

    def capture(cmodel, *a, **kw):
        captured["cmodel"] = cmodel
        captured["params"] = orig_reconstruct(cmodel, *a, **kw)
        return captured["params"]
    label = "eval --cluster-bits --save-cmodel --pack"
    eval_cli.reconstruct = capture
    try:
        out, counts, at, secs = _run_cli(
            torch, kernels, eval_cli.main,
            ["--cfg", cfg, "--weights", pruned, "--data", data, "--batch",
             str(BATCH), "--device", "cuda", "--cluster-bits",
             str(CLUSTER_BITS), "--save-cmodel", cpath, "--pack", "huffman"],
            label)
    finally:
        eval_cli.reconstruct = orig_reconstruct
    widths["eval_cluster"] = at
    expect_launches(kernels, counts, at, label,
                    forwards_want(spec, n_batches),
                    {"input_stage_mma": {c1: n_batches}})
    check(load_huffcodec() is not None, "the native Huffman codec did not "
          "load (g++ build into modelcompression_tpu_torch/_build)")
    loaded, _ = load_cmodel(cpath, spec=spec)
    x = _frames_on_card(torch, 2)
    with torch.inference_mode():
        raw = [forward_folded(params_to(fold_batchnorm(p, spec), "cuda"), x,
                              spec, FAST, fuse_input_stage=True)
               for p in (captured["params"], loaded)]
    check(torch.equal(raw[0], raw[1]), "the served cmodel's raw maps differ "
          "from the reconstructed params'")
    entry = captured["cmodel"][DECODE_LAYER]
    fields = packing.pack_codes(entry["codes"], entry["codebook"].size,
                                "huffman")
    nc = entry["codes"].size
    t0 = time.perf_counter()
    for _ in range(10):
        native = packing.huffman_decode(fields["payload"],
                                        fields["huff_lengths"], nc)
    native_ms = (time.perf_counter() - t0) * 1e2
    t0 = time.perf_counter()
    py = packing._decode_py(fields["payload"], fields["huff_lengths"], nc)
    py_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(native, py)
          and np.array_equal(native, entry["codes"].ravel()),
          "native decode differs from _decode_py")
    listed = read_data_cfg(data)
    with open(listed["valid"]) as f:
        paths = f.read().split()
    det_dir = out_path("detect_cmodel_in")
    os.makedirs(det_dir, exist_ok=True)
    for p_ in paths[:DETECT_QMODEL_IMAGES]:
        shutil.copy(p_, det_dir)
    _, counts, at, secs_d = _run_cli(
        torch, kernels, detect.main,
        ["--cfg", cfg, "--cmodel", cpath, "--dir", det_dir, "--out-dir",
         out_path("detect_cmodel_out"), "--batch",
         str(DETECT_QMODEL_IMAGES), "--device", "cuda", "--deployment"],
        "detect --cmodel --dir")
    widths["detect_cmodel"] = at
    expect_launches(kernels, counts, at, "detect --cmodel",
                    forwards_want(spec, 1), {"input_stage_mma": {c1: 1}})
    widths["server_cmodel"] = phase_server(
        torch, kernels, card, extra=["--cmodel", cpath],
        want={"input_stage_mma": 1}, label="yolov2_voc_cmodel",
        phase="compress_server")
    qpath = out_path("qat-packed.npz")
    label = "finetune --qat --save-qmodel --pack"
    out_f, counts, at, secs_q = _run_cli(
        torch, kernels, finetune.main,
        ["--cfg", cfg, *base, "--weights", weights, "--steps",
         str(QAT_PACK_STEPS), "--qat", "--save-qmodel", qpath, "--pack",
         "--out", out_path("qat-packed.weights")], label)
    widths["finetune_qat_pack"] = at
    expect_launches(kernels, counts, at, label,
                    forwards_want(spec, n_batches),
                    {"input_stage_mma": {c1: n_batches}})
    with np.load(qpath) as z:
        n_packed = sum(f_.endswith("/wq_payload") for f_ in z.files)
    check(n_packed == len(spec.conv_indices()),
          f"{label}: {n_packed} packed int8 tensors")
    q, _ = load_qmodel(qpath, spec=spec)
    check(all(q[f"conv{i}"]["w_q"].dtype == torch.int8
              for i in spec.conv_indices()), f"{label}: unpacked w_q")
    ft_map = _map_line(out_f.split("int8 deployment (QAT grids):")[1])[0]
    out_e, _, _, _ = _run_cli(
        torch, kernels, eval_cli.main,
        ["--cfg", cfg, "--qmodel", qpath, "--data", data, "--batch",
         str(BATCH), "--device", "cuda"], "eval --qmodel (packed)")
    check(_map_line(out_e)[0] == ft_map, f"eval --qmodel of the packed "
          f"export: mAP {_map_line(out_e)[0]}, finetune printed {ft_map}")
    done("share", bits=CLUSTER_BITS, seconds=secs,
         map50=_map_line(out)[0], artifact_bytes=os.path.getsize(cpath),
         weights_bytes=os.path.getsize(pruned),
         bits_per_weight=os.path.getsize(cpath) * 8 / sum(
             p["w"].numel() for p in params.values()),
         raw_maps_equal=True, native_codec=True,
         decode_layer=DECODE_LAYER, decode_codes=int(nc),
         native_decode_ms=native_ms, py_decode_ms=py_ms, detect_s=secs_d,
         qat_pack={"seconds": secs_q, "packed_tensors": n_packed,
                   "bytes": os.path.getsize(qpath), "int8_map50": ft_map,
                   "qmodel_map_equal": True})
    return widths


DP_STEPS = 2
DEPLOY_FRACTION = 0.5
EXPORT_BATCHES = (1, BATCH)
EXPORT_TIMED = 10


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms (and no autotuning) inside; the
    ranks a CLI starts take the same settings."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _rank_cli(torch, kernels, main, argv, label, out_dir):
    """A CLI run with --dp, whose work runs in rank processes: the
    launcher must launch nothing itself, and rank 0's launch counts come
    from the file it writes (``parallel.ranks.LAUNCHES_DIR_ENV``). Returns
    (rank 0's launches, by width, seconds)."""
    from modelcompression_tpu_torch.parallel.ranks import LAUNCHES_DIR_ENV
    os.makedirs(out_dir, exist_ok=True)
    os.environ[LAUNCHES_DIR_ENV] = out_dir
    try:
        _, counts, _, secs = _run_cli(torch, kernels, main, argv, label)
    finally:
        del os.environ[LAUNCHES_DIR_ENV]
    check(not any(counts.values()), f"{label}: the launcher itself "
          f"launched {counts}")
    with open(os.path.join(out_dir, "rank0.json")) as f:
        rank0 = json.load(f)
    return ({k.source: rank0[k.source]["launches"] for k in kernels},
            {k.source: {int(w): c for w, c in rank0[k.source]["at"].items()}
             for k in kernels}, secs)


def phase_parallel_deploy(torch, kernels, card, tmp, data, weights):
    """Phase 13 (module docstring): data parallelism on one card (--dp 1
    through eval, serve and finetune, NCCL at world size 1), the export
    CLI and the deploy recipe on full-width YOLOv2-VOC 416 (phase 6's
    weights, phase 7's fixture). Returns each path's launches by width."""
    from modelcompression_tpu_torch.utils.timing import time_fn
    import urllib.request

    import numpy as np
    import torch.distributed as dist
    from modelcompression_tpu_torch.cli import deploy, export, finetune, serve
    from modelcompression_tpu_torch.cli import eval as eval_cli
    from modelcompression_tpu_torch.cli.common import (
        run_padded_batch, unpack_detections,
    )
    from modelcompression_tpu_torch.core.mesh import MeshConfig, make_mesh
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models import (
        cfg_path, fold_batchnorm, load_cfg, load_weights, params_to,
    )
    from modelcompression_tpu_torch.parallel import ranks
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    params, _ = load_weights(weights, spec)  # phase 6's, from seed 0
    n_batches = -(-EVAL_IMAGES // BATCH)
    sub = spec.net.subdivisions
    c1 = spec.layers[0].filters
    s_layer = len(spec.conv_indices()) + 1  # + the padding segment
    widths = {}
    t_part = [time.perf_counter()]

    def done(part, **kw):
        now = time.perf_counter()
        emit({"phase": "parallel_deploy", "part": part, "ok": True,
              "card": card, "part_s": now - t_part[0], **kw})
        t_part[0] = now

    def out_path(name):
        return os.path.join(tmp, name)

    # (a) the mesh: one wider than the visible cards raises the JAX text
    n_dev = torch.cuda.device_count()
    try:
        make_mesh(MeshConfig(data=n_dev + 1))
        raised = None
    except ValueError as e:
        raised = str(e)
    want = (f"mesh MeshConfig(data={n_dev + 1}, model=1) needs "
            f"{n_dev + 1} devices, have {n_dev}")
    check(raised == want, f"make_mesh raised {raised!r}, expected {want!r}")
    mesh1 = make_mesh(MeshConfig(data=1))
    check(mesh1.data_devices == (torch.device("cuda", 0),),
          f"--dp 1 mesh on {mesh1.data_devices}")
    done("mesh", error=raised, dp1_devices=[str(d) for d in
                                             mesh1.data_devices])

    # (b) eval --dp 1 against eval, FAST at batch 64
    base = ["--cfg", cfg, "--weights", weights, "--data", data, "--batch",
            str(BATCH), "--device", "cuda"]
    evals = {}
    for tag, extra in (("eval", []), ("eval_dp1", ["--dp", "1"])):
        out, counts, at, secs = _run_cli(torch, kernels, eval_cli.main,
                                         base + extra, tag)
        expect_launches(kernels, counts, at, tag,
                        forwards_want(spec, n_batches),
                        {"input_stage_mma": {c1: n_batches}})
        widths[tag] = at
        evals[tag] = {"seconds": secs, "summary": _summary_lines(out)}
    check(evals["eval_dp1"]["summary"] == evals["eval"]["summary"],
          "eval --dp 1 summary differs from eval's")
    done("eval_dp1", seconds={k: v["seconds"] for k, v in evals.items()},
         map_line=[ln for ln in evals["eval"]["summary"]
                   if ln.startswith("mAP@")])

    # (c) serve --dp 1: 3 requests, /stats and /healthz say dp 1, every
    # request's detections equal to the one-device step's on its canvas
    args = serve.build_parser().parse_args(
        ["--cfg", cfg, "--weights", weights, "--host", "127.0.0.1",
         "--port", "0", "--deployment", "--batch", str(BATCH), "--device",
         "cuda", "--max-wait-ms", "20", "--dp", "1"])
    httpd, state = serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        rng = np.random.default_rng(SEED)
        canvases = [rng.integers(0, 256, (NET, NET, 3), np.uint8)
                    for _ in range(3)]
        reset_counts(kernels)
        items = [state.submit(c, float(SRC_W), float(SRC_H))
                 for c in canvases]
        for it in items:
            check(it is not None and it.event.wait(300)
                  and it.error is None, "serve --dp 1: a request failed")
        deadline = time.monotonic() + 60
        while state.stats()["images"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        counts, at = read_counts(kernels), read_widths(kernels)
        check(stats["dp"] == 1 and health["dp"] == 1
              and stats["images"] == 3, f"serve --dp 1: /stats {stats}")
        expect_launches(kernels, counts, at, "serve --dp 1",
                        forwards_want(spec, stats["batches"]),
                        {"input_stage_mma": {c1: stats["batches"]}})
        widths["serve_dp1"] = at
        direct_step = make_eval_step(spec, state.cfg)
        sel, sc, valid = run_padded_batch(
            direct_step, state.params[0], canvases, [float(SRC_W)] * 3,
            [float(SRC_H)] * 3, BATCH)
        for i, it in enumerate(items):
            want = unpack_detections(sel[i], sc[i], valid[i], SRC_W, SRC_H)
            got = [{k: d[k] for k in ("class_id", "score", "box")}
                   for d in it.result]
            check(got == want, f"serve --dp 1: request {i} detections "
                  f"differ from the direct step's")
        done("serve_dp1", stats=stats, launches=counts,
             detections=[len(it.result) for it in items])
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    # (d) finetune --dp 1 (one NCCL rank) against finetune, 2 steps at the
    # cfg's batch 64 / subdivisions 8, cuDNN deterministic in both
    ft = ["--cfg", cfg, "--weights", weights, "--data", data, "--steps",
          str(DP_STEPS), "--batch", str(BATCH), "--subdivisions", str(sub),
          "--device", "cuda"]
    eval_want = (forwards_want(spec, n_batches),
                 {"input_stage_mma": {c1: n_batches}})
    runs = {}
    with deterministic_cudnn(torch):
        _, counts, at, secs = _run_cli(
            torch, kernels, finetune.main,
            ft + ["--out", out_path("ft_plain.weights")], "finetune")
        expect_launches(kernels, counts, at, "finetune", *eval_want)
        runs["plain"] = secs
        counts, at, secs = _rank_cli(
            torch, kernels, finetune.main,
            ft + ["--dp", "1", "--out", out_path("ft_dp1.weights")],
            "finetune --dp 1", out_path("launches_ft_dp1"))
        expect_launches(kernels, counts, at, "finetune --dp 1", *eval_want)
        widths["finetune_dp1"] = at
        runs["dp1"] = secs
    (p_plain, seen_plain), (p_dp, seen_dp) = (
        load_weights(out_path(f"ft_{t}.weights"), spec)
        for t in ("plain", "dp1"))
    max_diff = max(float((p_dp[k][n] - v).abs().max())
                   for k, p in p_plain.items() for n, v in p.items())
    check(seen_dp == seen_plain and max_diff == 0.0,
          f"finetune --dp 1 differs from finetune: max |d| {max_diff}, "
          f"seen {seen_dp} vs {seen_plain}")
    prune_want = {n: DP_STEPS * k for n, k in PRUNE_LAUNCHES.items()}
    counts, at, secs = _rank_cli(
        torch, kernels, finetune.main,
        ft + ["--dp", "1", "--gmp", str(GMP_FINAL), "--gmp-begin", "0",
              "--gmp-end", str(DP_STEPS - 1), "--gmp-freq", "1", "--out",
              out_path("ft_dp1_gmp.weights")],
        "finetune --dp 1 --gmp", out_path("launches_ft_dp1_gmp"))
    expect_launches(kernels, counts, at, "finetune --dp 1 --gmp",
                    dict(prune_want, **forwards_want(spec, n_batches)),
                    dict({n: {s_layer: k} for n, k in prune_want.items()},
                         input_stage_mma={c1: n_batches}))
    widths["finetune_dp1_gmp"] = at
    runs["dp1_gmp"] = secs
    written, _ = load_weights(out_path("ft_dp1_gmp.weights"), spec)
    zeros = {k: int((p["w"] == 0).sum()) for k, p in written.items()}
    floors = {k: int(np.float32(GMP_FINAL) * np.float32(p["w"].numel()))
              for k, p in written.items()}
    check(all(zeros[k] >= floors[k] for k in zeros),
          "finetune --dp 1 --gmp: a layer below floor(s n) zeros")
    n_bn = sum(1 for i in spec.conv_indices()
               if spec.layers[i].batch_normalize)
    # a step's collectives: the BN moments forward and backward per conv
    # and micro-batch, the loss sums per micro-batch, the gradients once
    n_coll = 2 * n_bn * sub + sub + 1
    ranks.init_grid(mesh1, 0, "nccl", f"file://{out_path('pg_store')}")
    try:
        timing = [train_step_timing(torch, spec, params, sub, timed=2,
                                    mesh=m)
                  for m in (None, mesh1, mesh1, None)]
        moments = torch.zeros(2, 1024, device="cuda")

        def collectives():
            for _ in range(n_coll):
                dist.all_reduce(moments)

        collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives()
        host_ms = (time.perf_counter() - t0) * 1e3
        coll_ms = time_fn(collectives, iters=3, warmup=1, windows=1) * 1e3
    finally:
        ranks.destroy_grid()
    done("finetune_dp1", seconds=runs, bit_equal=max_diff == 0.0,
         seen=seen_dp, launches_gmp=counts, step_ms=_in_turns(timing),
         bn_all_reduces_per_step=2 * n_bn * sub,
         collectives_per_step=n_coll,
         collectives_alone={"host_enqueue_ms": host_ms, "ms": coll_ms,
                            "host_enqueue_ms_each": host_ms / n_coll,
                            "ms_each": coll_ms / n_coll,
                            "elements": moments.numel()},
         step_note="--dp 1: the BN moments all-reduced per micro-batch "
                   "(forward, and their gradients in the backward), the "
                   "loss sums per micro-batch, one flat gradient "
                   "all-reduce a step (NCCL, world size 1)")

    # (e) export at batch 1 and 64: seconds, bytes, the CLI's verify, and
    # the exported program against the live eager step (CUDA events)
    exports = {}
    folded = params_to(fold_batchnorm(params, spec), "cuda")
    live = make_eval_step(spec, EvalConfig(
        conf_thresh=0.25, nms_thresh=0.45, max_detections=50,
        precision=BITMATCH, fuse_input_stage=False, device="cuda"))
    for b in EXPORT_BATCHES:
        path = out_path(f"yolov2_b{b}.pt2")
        out, counts, at, secs = _run_cli(
            torch, kernels, export.main,
            ["--cfg", cfg, "--weights", weights, "--out", path, "--batch",
             str(b), "--platforms", "cuda"], f"export --batch {b}")
        expect_launches(kernels, counts, at, f"export --batch {b}", {}, {})
        check("verify ok" in out, f"export --batch {b}: no verify line")
        nodes = re.search(r"(\d+) graph nodes", out)
        program = torch.export.load(path).module()
        gen = torch.Generator(device="cuda").manual_seed(SEED + b)
        images = torch.randint(0, 256, (b, NET, NET, 3), generator=gen,
                               device="cuda", dtype=torch.uint8)
        wh = torch.full((b,), float(NET), device="cuda")
        got = program(images, wh, wh)
        want = live(folded, images, wh, wh)
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        check(bool((got[2] == want[2]).all()),
              f"export --batch {b}: valid flags differ from the live step")

        def run_program():
            with torch.inference_mode():
                program(images, wh, wh)

        ms = [time_fn(fn, EXPORT_TIMED, windows=1) * 1e3 for fn in (
            lambda: live(folded, images, wh, wh), run_program, run_program,
            lambda: live(folded, images, wh, wh))]
        exports[b] = {"export_s": secs, "bytes": os.path.getsize(path),
                      "graph_nodes": int(nodes.group(1)) if nodes else None,
                      "verify": "ok", "max_abs_err_vs_live": err,
                      "ms_live": [ms[0], ms[3]], "ms_pt2": [ms[1], ms[2]]}
        del program
        os.remove(path)
    done("export", exports=exports, precision="bitmatch")

    # (f) deploy: prune 0.5 + 2 steps, QAT 2 steps, 6-bit cmodel, .pt2
    out_dir = out_path("deploy")
    out, counts, at, secs = _run_cli(
        torch, kernels, deploy.main,
        ["--cfg", cfg, "--weights", weights, "--data", data, "--out-dir",
         out_dir, "--fractions", str(DEPLOY_FRACTION), "--steps", "2",
         "--qat-steps", "2", "--cluster-bits", str(CLUSTER_BITS),
         "--export", "saved_model", "--eval-batch", str(BATCH), "--device",
         "cuda"], "deploy")
    c_slim = int(c1 * (1 - DEPLOY_FRACTION))
    # evals at C=32: the baseline; at the slim width: the round's, the
    # pruned stage's, QAT's float eval and the cmodel's (int8: none)
    expect_launches(kernels, counts, at, "deploy",
                    forwards_want(spec, 5 * n_batches),
                    {"input_stage_mma": {c1: n_batches,
                                         c_slim: 4 * n_batches}})
    widths["deploy"] = at
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    check(set(report) == {"stages", "artifacts", "wall_s"}
          and set(report["stages"]) == {"baseline", "pruned", "int8"}
          and set(report["artifacts"]) == {"slim.weights", "deploy.qz",
                                           "deploy.cz", "saved_model"},
          f"deploy report keys: {sorted(report)}")
    check("verify ok" in out, "deploy: the export stage did not verify")
    done("deploy", wall_s=secs, report=report, launches=counts,
         launches_by_width=at)

    # (g) export of deploy's int8 artifact: the hybrid's int8 convs
    # (cuBLASLt through torch._int_mm) traced into the program, FAST
    out, counts, at, secs = _run_cli(
        torch, kernels, export.main,
        ["--cfg", os.path.join(out_dir, "slim.cfg"), "--qmodel",
         os.path.join(out_dir, "deploy.qz"), "--out",
         out_path("slim_int8.pt2"), "--batch", "1", "--platforms", "cuda"],
        "export --qmodel")
    expect_launches(kernels, counts, at, "export --qmodel", {}, {})
    agree = re.search(r"valid-flag agreement ([0-9.]+)%, max score drift "
                      r"(\S+)", out)
    check(agree is not None, "export --qmodel: no advisory verify line")
    done("export_qmodel", export_s=secs,
         bytes=os.path.getsize(out_path("slim_int8.pt2")),
         valid_agreement_pct=float(agree.group(1)),
         max_score_drift=float(agree.group(2)))
    return widths


TP = 2
TP_STEPS = 2
# the float64 and FAST steps held against the plain ones: the cfg's
# micro-batch of 8, twice
TP_F64_BATCH, TP_F64_SUB = 16, 2


def _tp_mesh(torch):
    """The (1, 2) mesh whose two ranks share cuda:0: the analogue of the
    JAX tests' forced host devices on a one-card machine. NCCL refuses
    two ranks on one card, so its ranks run gloo, which takes CUDA tensors
    in every collective the step writes out."""
    from modelcompression_tpu_torch.core.mesh import MeshConfig, make_mesh
    return make_mesh(MeshConfig(data=1, model=TP),
                     devices=[torch.device("cuda", 0)] * TP)


def _tp_one_step(torch, spec, params, mesh, precision, batch, sub):
    """One step from ``params`` at ``precision`` on a fixed batch: the
    plain step on rank 0 alone (the other rank waits), then the
    tensor-parallel step on every rank. Returns, on rank 0, each step's
    gradients and updated params (the TP ones gathered whole), and the
    TP step's collectives by kind."""
    import torch.distributed as dist
    from modelcompression_tpu_torch.parallel import place_train_state, ranks
    from modelcompression_tpu_torch.parallel.sharding import (
        gather_params, sharded_keys,
    )
    from modelcompression_tpu_torch.train import (
        TrainConfig, TrainState, make_optimizer, make_train_step,
    )
    config = TrainConfig.from_spec(spec, precision=precision,
                                   subdivisions=sub, augment_flip=False,
                                   augment_jitter=0.0)
    images, targets = _train_batch(torch, batch, SEED + 14, "cuda")
    grid = ranks.grid()
    dev = {k: {n: v.to("cuda", precision.param_dtype)
               for n, v in p.items()} for k, p in params.items()}

    def state():
        return TrainState.create(dev, make_optimizer(config),
                                 torch.Generator().manual_seed(SEED))

    def taken(st, grads):
        return ({k: {n: v.detach() for n, v in p.items()}
                 for k, p in grads.items()},
                {k: {n: v.detach() for n, v in p.items()}
                 for k, p in st["params"].items()})

    out = {}
    if grid.rank == 0:
        st, _ = make_train_step(spec, config)(state(), images, targets)
        out["plain"] = taken(st, {k: {n: v.grad for n, v in p.items()
                                      if v.grad is not None}
                                  for k, p in st["params"].items()})
    dist.barrier()
    st = place_train_state(state(), mesh, spec, tp=True, rank=grid.rank)
    step = make_train_step(spec, config, mesh=mesh)
    ranks.reset_collectives()
    st, _ = step(st, images, targets)
    torch.cuda.synchronize()
    out["collectives"] = {k: dict(v) for k, v in ranks.COLLECTIVES.items()}
    keys = sharded_keys(spec, TP)
    grads = {k: {n: (ranks.all_gather_rows(v.grad, grid.model_group)
                     if k in keys else v.grad)
                 for n, v in p.items() if v.grad is not None}
             for k, p in st["params"].items()}
    out["tp"] = taken({"params": gather_params(st["params"], mesh, spec)},
                      grads)
    return out


def _worst(got, want):
    """(largest _max_rel over the tensors of two {key: {name: tensor}}
    trees, the tensor's name)."""
    return max((_max_rel(got[k][n].double(), v.double()), f"{k}/{n}")
               for k, p in want.items() for n, v in p.items())


def _tp_step_rank(argv):
    """Rank target of phase 14 (b) and (d): ``argv`` = [weights, result
    json]. Rank 0 writes the results."""
    import torch
    import torch.distributed as dist
    from modelcompression_tpu_torch.core.precision import FAST, Precision
    from modelcompression_tpu_torch.models import cfg_path, load_cfg
    from modelcompression_tpu_torch.models import load_weights
    from modelcompression_tpu_torch.parallel import ranks
    weights, result = argv
    spec = load_cfg(cfg_path("yolov2-voc.cfg"))
    params, _ = load_weights(weights, spec)
    mesh = ranks.grid().mesh
    primary = ranks.grid().rank == 0
    res = {"backend": ranks.grid().backend}
    f64 = Precision(name="float64", compute_dtype=torch.float64,
                    param_dtype=torch.float64)
    got = {name: _tp_one_step(torch, spec, params, mesh, prec, TP_F64_BATCH,
                              TP_F64_SUB)
           for name, prec in (("float64", f64), ("fast", FAST))}
    if primary:
        (g64, p64), (g64_tp, p64_tp) = got["float64"]["plain"], \
            got["float64"]["tp"]
        worst = _worst(g64_tp, g64)
        res["float64"] = {
            "batch": TP_F64_BATCH, "subdivisions": TP_F64_SUB,
            "worst_grad_rel": worst[0], "worst": worst[1],
            "max_param_abs_diff": max(
                float((p64_tp[k][n] - v).abs().max())
                for k, p in p64.items() for n, v in p.items()),
            "collectives": got["float64"]["collectives"]}
        # FAST (bf16 convs) from the same params: each step's distance
        # from the plain float64 step, and the TP step's from the plain
        (g, p), (g_tp, p_tp) = got["fast"]["plain"], got["fast"]["tp"]
        res["fast"] = {
            "grad_rel": {"tp_vs_plain": _worst(g_tp, g),
                         "plain_vs_float64": _worst(g, g64),
                         "tp_vs_float64": _worst(g_tp, g64)},
            "param_rel": {"tp_vs_plain": _worst(p_tp, p),
                          "plain_vs_float64": _worst(p, p64),
                          "tp_vs_float64": _worst(p_tp, p64)}}
    # the FAST step at the cfg's batch 64 / subdivisions 8, in turns: the
    # plain step on rank 0 alone, the TP step on both ranks; the TP
    # turns' collectives counted over their 2 warm-up and 1 timed step
    timing = []
    ranks.reset_collectives()
    for m in (None, mesh, mesh, None):
        dist.barrier()
        if m is not None or primary:
            timing.append(train_step_timing(
                torch, spec, params, spec.net.subdivisions, timed=1,
                mesh=m))
    if primary:
        steps = 2 * (2 + 1)
        res["step_ms"] = _in_turns(timing)
        res["enqueue_ms"] = [t["host_enqueue_ms_per_step"] for t in timing]
        res["peak_gib"] = [t["max_memory_allocated_gib"] for t in timing]
        res["collectives_per_step"] = {
            k: {"calls": v["calls"] / steps, "host_ms": v["host_ms"] / steps}
            for k, v in ranks.COLLECTIVES.items()}
        with open(result, "w") as f:
            json.dump(res, f)
    return 0


def phase_tensor_parallel(torch, kernels, card, tmp, data, weights):
    """Phase 14 (module docstring): tensor parallelism on full-width
    YOLOv2-VOC 416 (phase 6's weights, phase 7's fixture) over a (1, 2)
    mesh whose ranks share cuda:0 (gloo). Returns each rank's launches
    by width."""
    import numpy as np
    from modelcompression_tpu_torch.cli import finetune
    from modelcompression_tpu_torch.models import (
        cfg_path, load_cfg, load_weights,
    )
    from modelcompression_tpu_torch.parallel import ranks
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    n_batches = -(-EVAL_IMAGES // BATCH)
    c1 = spec.layers[0].filters
    s_layer = len(spec.conv_indices()) + 1
    t_part = [time.perf_counter()]

    def done(part, **kw):
        now = time.perf_counter()
        emit({"phase": "tensor_parallel", "part": part, "ok": True,
              "card": card, "part_s": now - t_part[0], **kw})
        t_part[0] = now

    def out_path(name):
        return os.path.join(tmp, name)

    ft = ["--cfg", cfg, "--weights", weights, "--data", data, "--steps",
          str(TP_STEPS), "--batch", str(BATCH), "--subdivisions",
          str(spec.net.subdivisions), "--device", "cuda"]
    # (a) --tp 2 through the CLI wants one card per rank: on a one-card
    # machine it exits 2 with the JAX text
    n_dev = torch.cuda.device_count()
    if n_dev < TP:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = finetune.main(ft + ["--tp", str(TP), "--out",
                                     out_path("tp_cli.weights")])
        want = (f"mesh MeshConfig(data=1, model={TP}) needs {TP} devices, "
                f"have {n_dev}")
        check(rc == 2 and want in err.getvalue(),
              f"finetune --tp {TP} on {n_dev} card(s): exit {rc}, "
              f"{err.getvalue()!r}")
        done("cli_mesh", error=want)

    mesh = _tp_mesh(torch)
    # (b) and (d): the TP step against the plain step, and in turns
    result = out_path("tp_steps.json")
    reset_counts(kernels)
    t0 = time.perf_counter()
    rc = ranks.spawn("chip_smoke:_tp_step_rank", [weights, result], mesh,
                     backend="gloo")
    secs = time.perf_counter() - t0
    check(rc == 0, f"tensor-parallel step ranks exited {rc}")
    with open(result) as f:
        res = json.load(f)
    f64 = res.pop("float64")
    check(f64["worst_grad_rel"] <= STEP_GRAD_TOL,
          f"TP float64 step: {f64['worst']} differs by "
          f"{f64['worst_grad_rel']} of its max |g| from the plain step's")
    done("step", seconds=secs,
         staging="none: gloo takes the CUDA tensors of every collective",
         float64=f64, **res,
         note="two ranks share one card: the times are the TP code "
              "path's host and gloo cost, not NVLink's")

    # (c) the finetune ranks with GMP: each rank recomputes the masks on
    # the gathered weights through the top-k kernels; rank 0 evaluates
    counts_dir = out_path("launches_tp")
    os.makedirs(counts_dir, exist_ok=True)
    os.environ[ranks.LAUNCHES_DIR_ENV] = counts_dir
    out = out_path("ft_tp_gmp.weights")
    argv = ft + ["--tp", str(TP), "--gmp", str(GMP_FINAL), "--gmp-begin",
                 "0", "--gmp-end", str(TP_STEPS - 1), "--gmp-freq", "1",
                 "--out", out]
    reset_counts(kernels)
    t0 = time.perf_counter()
    try:
        rc = ranks.spawn("modelcompression_tpu_torch.cli.finetune:main",
                         argv, mesh, backend="gloo")
    finally:
        del os.environ[ranks.LAUNCHES_DIR_ENV]
    secs = time.perf_counter() - t0
    check(rc == 0, f"finetune --tp {TP} ranks exited {rc}")
    counts = read_counts(kernels)
    check(not any(counts.values()), f"finetune --tp: the launcher itself "
          f"launched {counts}")
    prune_want = {n: TP_STEPS * k for n, k in PRUNE_LAUNCHES.items()}
    widths, per_rank = {}, {}
    for r in range(TP):
        with open(os.path.join(counts_dir, f"rank{r}.json")) as f:
            got = json.load(f)
        counts = {k.source: got[k.source]["launches"] for k in kernels}
        at = {k.source: {int(w): c for w, c in got[k.source]["at"].items()}
              for k in kernels}
        eval_want = forwards_want(spec, n_batches) if r == 0 else {}
        expect_launches(
            kernels, counts, at, f"finetune --tp rank {r}",
            dict(prune_want, **eval_want),
            dict({n: {s_layer: k} for n, k in prune_want.items()},
                 **({"input_stage_mma": {c1: n_batches}} if r == 0
                    else {})))
        widths[f"finetune_tp_gmp_rank{r}"] = at
        per_rank[r] = {"launches": counts,
                       "collectives": got["collectives"]}
    written, _ = load_weights(out, spec)
    zeros = {k: int((p["w"] == 0).sum()) for k, p in written.items()}
    floors = {k: int(np.float32(GMP_FINAL) * np.float32(p["w"].numel()))
              for k, p in written.items()}
    check(all(zeros[k] >= floors[k] for k in zeros),
          "finetune --tp --gmp: a layer below floor(s n) zeros")
    done("finetune_tp_gmp", seconds=secs, ranks=per_rank,
         zeros=sum(zeros.values()), floor_zeros=sum(floors.values()))
    return widths


TOOL_FRACTIONS = (0.25, 0.5, 0.75)
# the sweeps at cut step counts (the tools' own: 600 base steps, then 200
# a sparsity or 400 a round; run in full by tools/fixture_tables)
SWEEP_BASE_STEPS = 40
SWEEP_TUNE_STEPS = 10
# the widths the sweeps' evals give the input stage: the fixture's 16
# filters, and what each L1 round leaves of them (12, 8, 4)
FIXTURE_WIDTHS = (16, 12, 8, 4)
FIXTURE_EVAL_BATCH = 8
BITMATCH_NET = 128
BITMATCH_RAW_RTOL = 1e-4
BACKBONE_CONVS = 18


def _tool_layers(spec):
    """conv 0, a mid and the last prunable conv of the spec."""
    from modelcompression_tpu_torch.compress import prunable_conv_indices
    prunable = prunable_conv_indices(spec)
    return [prunable[0], prunable[len(prunable) // 2], prunable[-1]]


def _kept(filters, fraction):
    return filters - int(fraction * filters)


def phase_tools(torch, kernels, card, tmp, data, weights):
    """Phase 15 (module docstring): the user tools on the card. Returns
    (each path's launches by width, the input-stage cases at the tools'
    widths and shapes, the top-k cases at the fixture's S)."""
    from modelcompression_tpu_torch.cli import profile_train
    from modelcompression_tpu_torch.data.fixtures import tiny_region_cfg
    from modelcompression_tpu_torch.models import (
        cfg_path, load_cfg, load_weights, parse_cfg,
    )
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    from modelcompression_tpu_torch.tools import (
        bitmatch_check, gen_anchors, lowrank_scan, partial_weights,
        sensitivity_scan, sweep_fixture, sweep_l1_iterative,
    )
    from modelcompression_tpu_torch.utils import perf_ledger
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    n_batches = -(-EVAL_IMAGES // BATCH)
    widths, cases, topk = {}, {}, {}
    t_part = [time.perf_counter()]

    def done(part, **kw):
        now = time.perf_counter()
        emit({"phase": "tools", "part": part, "ok": True, "card": card,
              "part_s": now - t_part[0], **kw})
        t_part[0] = now

    # (a) the sensitivity scan: each conv alone at each fraction, every
    # evaluation through the tensor-core input stage at conv 0's width
    layers = _tool_layers(spec)
    c1 = spec.layers[0].filters
    out, counts, at, secs = _run_cli(
        torch, kernels, sensitivity_scan.main,
        ["--cfg", cfg, "--weights", weights, "--data", data, "--batch",
         str(BATCH), "--fractions", ",".join(map(str, TOOL_FRACTIONS)),
         "--layers", ",".join(map(str, layers))], "sensitivity_scan")
    rows = [ln for ln in out.splitlines() if ln.startswith("conv[")]
    cells = [float(v) for r in rows for v in r.split(")", 1)[1].split()]
    check(len(rows) == len(layers)
          and len(cells) == len(layers) * len(TOOL_FRACTIONS)
          and all(0.0 <= v <= 100.0 for v in cells),
          f"sensitivity_scan: rows {rows}")
    c_want = {c1: n_batches * (1 + (len(layers) - 1) * len(TOOL_FRACTIONS))}
    for f in TOOL_FRACTIONS:
        c_want[_kept(c1, f)] = c_want.get(_kept(c1, f), 0) + n_batches
    n_evals = 1 + len(layers) * len(TOOL_FRACTIONS)
    expect_launches(kernels, counts, at, "sensitivity_scan",
                    forwards_want(spec, n_batches * n_evals),
                    {"input_stage_mma": c_want})
    widths["sensitivity_scan"] = at
    done("sensitivity_scan", seconds=secs, layers=layers,
         evaluations=n_evals, input_stage_by_width=at["input_stage_mma"],
         rows=rows)

    # the new widths against the plain version: the scan's cuts of conv 0
    # at the main path's shape, a width that is not a multiple of 8, the
    # sweeps' evaluation shape at each width they give, and the BITMATCH
    # check's fp32 shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [(c, dt, BATCH, NET) for c in (24, 12)
              for dt in (torch.bfloat16, torch.float32)]
    shapes += [(c, torch.bfloat16, FIXTURE_EVAL_BATCH, sweep_fixture.NET)
               for c in FIXTURE_WIDTHS]
    shapes.append((16, torch.float32, 4, BITMATCH_NET))
    for c, dt, b, net in shapes:
        r = input_stage_case(torch, c, dt, gen, batch=b, net=net,
                             device_times=(b, net) != (BATCH, NET))
        cases[(c, r["dtype"], b, net)] = r
        emit({"phase": "tools", "ok": True, **r})
    done("input_stage_cases", cases=len(shapes))

    # (b) the unstructured sweep: masks through the top-k kernels, each
    # equal to prune_flat's plain version on the same trained weights
    fx_spec = parse_cfg(tiny_region_cfg(num_classes=3,
                                        width=sweep_fixture.NET,
                                        height=sweep_fixture.NET))
    s_layer = len(fx_spec.conv_indices()) + 1
    n_sp = len(sweep_fixture.SPARSITIES)
    fx_batches = -(-16 // FIXTURE_EVAL_BATCH)
    for criterion in sweep_fixture.MASK_FNS:
        s_want = s_layer if criterion == "magnitude" else 2
        reset_counts(kernels)
        t0 = time.perf_counter()
        r = sweep_fixture.run(criterion, torch.device("cuda"),
                              base_steps=SWEEP_BASE_STEPS,
                              tune_steps=SWEEP_TUNE_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, at = read_counts(kernels), read_widths(kernels)
        prune_want = {n: n_sp * k for n, k in PRUNE_LAUNCHES.items()}
        evals = (1 + 2 * n_sp) * fx_batches
        expect_launches(
            kernels, counts, at, f"sweep_fixture {criterion}",
            dict(prune_want, **forwards_want(fx_spec, evals)),
            dict({n: {s_want: k} for n, k in prune_want.items()},
                 input_stage_mma={FIXTURE_WIDTHS[0]: evals}))
        widths[f"sweep_fixture_{criterion}"] = at
        fn = sweep_fixture.MASK_FNS[criterion]
        zeros_ok = []
        for row in r["rows"]:
            with plain_topk(), torch.no_grad():
                want = fn(r["params"], r["spec"], row["sparsity"])
            check(want.keys() == row["masks"].keys() and all(
                torch.equal(row["masks"][k], want[k]) for k in want),
                f"sweep_fixture {criterion} {row['sparsity']}: a mask "
                "differs from prune_flat's plain version")
            zeros = {k: int((~m).sum()) for k, m in row["masks"].items()}
            n = {k: m.numel() for k, m in row["masks"].items()}
            if criterion == "magnitude":
                ok = all(zeros[k] >= int(row["sparsity"] * n[k])
                         for k in n)
            else:
                ok = sum(zeros.values()) >= int(row["sparsity"]
                                                * sum(n.values()))
            check(ok, f"sweep_fixture {criterion}: fewer than floor(s n) "
                  "zeros")
            check(all(math.isfinite(row[k]) for k in ("pruned", "tuned")),
                  f"sweep_fixture {criterion}: mAP {row}")
            zeros_ok.append(sum(zeros.values()))
        if criterion != "lamp":
            per_layer = criterion == "magnitude"
            layout = ct._prune_layout(r["params"], r["spec"], SPARSITY,
                                      per_layer, ())
            topk[criterion] = topk_case(torch, layout, "fixture",
                                        device_times=True)
            emit({"phase": "tools", "ok": True, "kernel": "topk",
                  **topk[criterion]})
        done(f"sweep_fixture_{criterion}", seconds=secs,
             base_steps=SWEEP_BASE_STEPS, tune_steps=SWEEP_TUNE_STEPS,
             segments=s_want, base_map50=r["base"],
             rows=[{k: row[k] for k in ("sparsity", "achieved", "pruned",
                                        "tuned")} for row in r["rows"]],
             zeros=zeros_ok, masks_equal_plain=True)

    # (c) the iterative L1 sweep on v2: the input stage at each round's
    # first-conv width (16, then 12, 8, 4)
    reset_counts(kernels)
    t0 = time.perf_counter()
    r = sweep_l1_iterative.run("v2", "l1", base_steps=SWEEP_BASE_STEPS,
                               round_steps=SWEEP_TUNE_STEPS,
                               device=torch.device("cuda"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, at = read_counts(kernels), read_widths(kernels)
    round_widths = [rd["spec"].layers[0].filters for rd in r["rounds"]]
    check(round_widths == list(FIXTURE_WIDTHS[1:]),
          f"sweep_l1_iterative: first-conv widths {round_widths}")
    mma_want = {FIXTURE_WIDTHS[0]: fx_batches}
    for c in round_widths:
        mma_want[c] = 2 * fx_batches  # after the prune, after the tune
    expect_launches(kernels, counts, at, "sweep_l1_iterative",
                    forwards_want(r["rounds"][0]["spec"],
                                  sum(mma_want.values())),
                    {"input_stage_mma": mma_want})
    widths["sweep_l1_iterative_v2"] = at
    check(all(math.isfinite(rd[k]) for rd in r["rounds"]
              for k in ("pruned", "recovered")),
          "sweep_l1_iterative: a non-finite mAP")
    done("sweep_l1_iterative", seconds=secs, base_map50=r["base"],
         rounds=[{"fraction": rd["fraction"], "conv0": w,
                  "pruned": rd["pruned"], "recovered": rd["recovered"]}
                 for rd, w in zip(r["rounds"], round_widths)])

    # (d) one stage table of the train step (75%-pruned, batch 64) and the
    # trace's top device operations
    out, counts, at, secs = _run_cli(
        torch, kernels, profile_train.main,
        ["--inner", "3", "--trace", os.path.join(tmp, "train_trace")],
        "profile_train")
    stages = {m.group(1): float(m.group(2)) for m in (
        re.match(r"(aug|fwd|loss|bwd|full)\s*:\s*([0-9.]+) ms/step", ln)
        for ln in out.splitlines()) if m}
    check(set(stages) == {"aug", "fwd", "loss", "bwd", "full"}
          and all(v > 0 and math.isfinite(v) for v in stages.values()),
          f"profile_train: stages {stages}")
    check(os.path.exists(os.path.join(tmp, "train_trace", "trace.json")),
          "profile_train --trace wrote no trace")
    done("profile_train", seconds=secs, stage_ms=stages)

    # (e) BITMATCH, card against CPU: raw maps, detections and mAP
    reset_counts(kernels)
    t0 = time.perf_counter()
    r = bitmatch_check.run(torch.device("cuda"))
    secs = time.perf_counter() - t0
    counts, at = read_counts(kernels), read_widths(kernels)
    # the raw forward and the eval's two batches of 4, on the card
    expect_launches(kernels, counts, at, "bitmatch_check",
                    {FP32_INPUT_STAGE: 3}, {FP32_INPUT_STAGE: {16: 3}})
    widths["bitmatch_check"] = at
    check(r["max_rel"] <= BITMATCH_RAW_RTOL,
          f"bitmatch_check: raw maps max rel {r['max_rel']}")
    check(r["mismatched"] == 0 and r["cpu_detections"] > 0,
          f"bitmatch_check: detections {r}")
    done("bitmatch_check", seconds=secs, **r)

    # (f) the host tools on the phase's weights and fixture
    out, *_ = _run_cli(torch, kernels, gen_anchors.main,
                       ["--data", data, "--num", "5"], "gen_anchors")
    line = [ln for ln in out.splitlines() if ln.startswith("anchors = ")]
    vals = [float(v) for v in line[0][len("anchors = "):].split(",")] \
        if line else []
    check(len(vals) == 10 and all(v > 0 for v in vals),
          f"gen_anchors: {line}")
    # Darknet-19's 18 convs: the backbone prefix a detector trains from
    backbone = os.path.join(tmp, f"darknet19.conv.{BACKBONE_CONVS}")
    out, *_ = _run_cli(torch, kernels, partial_weights.main,
                       ["--cfg", cfg, "--weights", weights, "--n-convs",
                        str(BACKBONE_CONVS), "--out", backbone],
                       "partial_weights")
    loaded, seen = load_weights(backbone, spec, partial=True)
    full, _ = load_weights(weights, spec)
    check(len(loaded) == BACKBONE_CONVS and seen == 0 and all(
        torch.equal(loaded[k][n], full[k][n]) for k in loaded
        for n in loaded[k]), f"partial_weights: the backbone holds "
          f"{len(loaded)} convs, seen {seen}, or differs from the source")
    out, *_ = _run_cli(torch, kernels, lowrank_scan.main,
                       ["--cfg", cfg, "--weights", weights],
                       "lowrank_scan")
    table = [ln for ln in out.splitlines() if ln[:5].strip().isdigit()]
    check(len(table) == len(spec.conv_indices()) and "E=0.99:" in out,
          f"lowrank_scan: {len(table)} rows")
    done("host_tools", anchors=line[0], backbone_bytes=os.path.getsize(
        backbone), lowrank_rows=len(table))

    # (g) one perf-ledger line to a temporary path, read back
    path = os.path.join(tmp, "perf_ledger.jsonl")
    entry = perf_ledger.append({"mode": "chip_smoke", "phase": "tools"},
                               path=path)
    back = perf_ledger.read(path)
    check(len(back) == 1 and back[0]["device"] == card == entry["device"],
          f"perf_ledger: read back {back}")
    done("perf_ledger", entry=back[0])
    return widths, cases, topk


TOPK_ENTRIES = (
    ("radix_select", "topk_radix_select", "pallas_topk.py:55"),
    ("tie_counts", "topk_tie_counts", "pallas_topk.py:190"),
    ("apply", "topk_apply", "pallas_topk.py:124"),
)


def kernel_entries(cases, launches, topk, prune_launches, eval_widths,
                   ft_widths, fam_widths, fam_topk, train_widths,
                   train_topk, int8_widths, quantile_select, cmp_widths,
                   par_widths, tp_widths, tool_widths, tool_cases,
                   tool_topk, epilogue):
    """The ``kernels`` line: one entry per main-path case of each kernel.
    The tensor-core input stage runs bf16 at C=32 in the unpruned model and
    at C=8 in the pruned one; the fp32 input stage runs on the card-vs-CPU
    (BITMATCH) forward of each model (C=32 and C=8). The top-k kernels
    run per layer (S=24, the magnitude prune) and globally (S=2) on the
    random weights. ``launches`` is that path's count. The radix select's
    entries time the whole select (``ms`` = ``select_ms``, its 5
    launches; ``pass_ms`` each launch) against the bound of reading its
    inputs once (``bound_ms``; ``pass_bound_ms`` one pass,
    ``four_pass_bound_ms`` the four passes). Its ``library_ms`` is
    torch.kthvalue on the |w| vector in global mode (S=2), the call that
    finds the same k-th |w|; no single PyTorch call computes the
    per-layer select (S=24). The tie-count and apply entries run at the
    chunk ``prune_flat`` sizes to the input (``chunk``), with the fixed
    16K chunk beside them (``chunk16k_ms``); no single PyTorch call computes
    their functions. ``eval_launches``, ``finetune_launches`` and
    ``families_launches`` count each case's launches on each path of the
    eval, finetune and families phases, read from the wrappers' counts by
    width (C or S). The families phase adds its own cases: the input
    stages at C=16 (YOLOv3-tiny serving, bf16, and its card-vs-CPU
    forward, fp32) and the top-k kernels at S=64 (the bisect prefilter
    over YOLOv4-VOC's 64 x 10,647 candidates; the radix entry's
    ``library_ms`` is torch.topk of the 128 best per image, the whole
    selection). The families-train phase adds the top-k kernels at
    YOLOv4-VOC's per-layer layout (S=111: 110 convs and the padding
    segment, 63,973,472 weights; no single PyTorch call computes the
    per-layer select), and every entry counts its launches on that
    phase's paths (``families_train_launches``). The int8 phase adds the
    radix select at the quantile calibration's layout (one segment per
    YOLOv2-VOC layer output and one for the input, S=33, over one chunk of
    8 images; ``launches`` is the calibration's, two selects per chunk),
    and every entry counts its launches on the int8 phase's paths
    (``int8_launches``: the tensor-core input stage in the QAT
    fine-tune's float eval, nothing on the int8 serving paths). Every
    entry counts its launches on the compression phase's paths
    (``compress_launches``: GMP's recompute at S=24 and S=2, LAMP's cut
    at S=2, the evals' input stage at C=32 and the distilled student's at
    C=8, the cmodel's serving), and on the data-parallel and deploy
    phase's (``parallel_launches``: eval / serve / finetune --dp 1, rank
    0's counts for finetune, GMP's recompute at S=24, deploy's evals at
    C=32 and C=16), and on the tensor-parallel phase's
    (``tensor_parallel_launches``: each rank of finetune --tp 2 --gmp,
    GMP's recompute on the gathered weights at S=24 in each, rank 0's
    eval at C=32), and on the tools phase's (``tools_launches``: the
    sensitivity scan's evals at C=32 / 24 / 16 / 8, the sweeps' at C=16
    / 12 / 8 / 4 and their masks at S=7 and S=2, the BITMATCH check's
    fp32 stage at C=16). The tools phase adds its own cases: the input
    stages at each new width and shape it holds (``batch``, ``net``;
    ``launches`` the phase's at that width, whatever the shape) and the
    top-k kernels at the fixture's S=7 (per layer) and S=2 (global),
    with each kernel's device time (``device_ms``). The conv epilogue's
    entry times phase 3b's 110 launches (YOLOv4-VOC 416's conv outputs at
    batch 64) against its bound, the plain version and the eager chain it
    replaced (``library_ms``); its ``launches`` are phase 4's serving step
    of the unpruned YOLOv2-VOC (one a conv, less conv 0 in the input
    stage), and every ``*_launches`` field counts its launches on each
    path of that phase, over all widths."""
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
            "eval_launches": on_eval(source, c_out),
            "finetune_launches": on_finetune(source, c_out),
            "families_launches": on(fam_widths, source, c_out),
            "families_train_launches": on(train_widths, source, c_out),
            "int8_launches": on(int8_widths, source, c_out),
            "compress_launches": on(cmp_widths, source, c_out),
            "parallel_launches": on(par_widths, source, c_out),
            "tensor_parallel_launches": on(tp_widths, source, c_out),
            "tools_launches": on(tool_widths, source, c_out)})
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
            "families_launches": on(fam_widths, source, 16),
            "families_train_launches": on(train_widths, source, 16),
            "int8_launches": on(int8_widths, source, 16),
            "compress_launches": on(cmp_widths, source, 16),
            "parallel_launches": on(par_widths, source, 16),
            "tensor_parallel_launches": on(tp_widths, source, 16),
            "tools_launches": on(tool_widths, source, 16)})

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
                "four_pass_bound_ms")})
            if library is not None:
                entry["library_ms"] = k["library_ms"]
                entry["library_computes"] = library
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
                 "families_launches": on(fam_widths, source, s),
                 "families_train_launches": on(train_widths, source, s),
                 "int8_launches": on(int8_widths, source, s),
                 "compress_launches": on(cmp_widths, source, s),
                 "parallel_launches": on(par_widths, source, s),
                 "tensor_parallel_launches": on(tp_widths, source, s),
                 "tools_launches": on(tool_widths, source, s)},
                None if s == 24 else
                "torch.kthvalue: the k-th |w| of the one real segment"))
    s = fam_topk["S"]
    for key, source, body in TOPK_ENTRIES:
        entries.append(topk_entry(
            fam_topk, key, source, body, f"{source}[S={s},bisect]",
            fam_widths["yolov4_voc_bisect"][source].get(s, 0),
            {"families_launches": on(fam_widths, source, s),
             "families_train_launches": on(train_widths, source, s),
             "int8_launches": on(int8_widths, source, s),
             "compress_launches": on(cmp_widths, source, s),
             "parallel_launches": on(par_widths, source, s),
             "tensor_parallel_launches": on(tp_widths, source, s),
             "tools_launches": on(tool_widths, source, s)},
            "torch.topk of the 128 best scores per image: the whole "
            "selection"))
    s = train_topk["S"]
    for key, source, body in TOPK_ENTRIES:
        entries.append(topk_entry(
            train_topk, key, source, body, f"{source}[S={s},yolov4]",
            train_widths["prune_magnitude_yolov4"][source].get(s, 0),
            {"families_train_launches": on(train_widths, source, s),
             "int8_launches": on(int8_widths, source, s),
             "compress_launches": on(cmp_widths, source, s),
             "parallel_launches": on(par_widths, source, s),
             "tensor_parallel_launches": on(tp_widths, source, s),
             "tools_launches": on(tool_widths, source, s)}, None))
    q = quantile_select
    entries.append({
        "name": f"topk_radix_select[S={q['S']},quantile]", "route": "cuda",
        "source": "modelcompression_tpu_torch/csrc/topk_radix_select.cu",
        "replaces": "modelcompression_tpu/ops/pallas_topk.py:55",
        "launches": q["launches"], "max_abs_err": q["max_abs_err"],
        "ms": q["ms"], "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
        "bound_by": q["bound_by"], "library_ms": None,
        "pass_ms": q["pass_ms"], "pass_bound_ms": q["pass_bound_ms"],
        "four_pass_bound_ms": q["four_pass_bound_ms"], "elements": q["n"],
        "int8_launches": on(int8_widths, "topk_radix_select", q["S"]),
        "compress_launches": on(cmp_widths, "topk_radix_select", q["S"]),
        "parallel_launches": on(par_widths, "topk_radix_select", q["S"]),
        "tensor_parallel_launches": on(tp_widths, "topk_radix_select",
                                       q["S"]),
        "tools_launches": on(tool_widths, "topk_radix_select", q["S"])})
    for (c_out, dtype, b, net), r in sorted(tool_cases.items()):
        source = r["kernel"]
        where = "" if (b, net) == (BATCH, NET) else f",B={b},{net}px"
        entries.append({
            "name": f"{source}[C={c_out}{where}]", "route": "cuda",
            "source": f"modelcompression_tpu_torch/csrc/{source}.cu",
            "replaces": "modelcompression_tpu/ops/input_stage.py:159",
            "launches": sum(n for n in on(tool_widths, source,
                                          c_out).values()),
            "batch": b, "net": net,
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("device_ms", "library_device_ms")
               if k in r},
            "tools_launches": on(tool_widths, source, c_out)})
    for mode, r in tool_topk.items():
        s = r["S"]
        for key, source, body_ in TOPK_ENTRIES:
            entries.append(topk_entry(
                r, key, source, body_, f"{source}[S={s},fixture]",
                sum(on(tool_widths, source, s).values()),
                {"tools_launches": on(tool_widths, source, s),
                 "device_ms": r[key].get("device_ms")}, None))

    def all_widths(widths):
        return {path: sum(at.get(EPILOGUE, {}).values())
                for path, at in widths.items()}

    f = epilogue["forward"]
    entries.append({
        "name": EPILOGUE, "route": "cuda",
        "source": f"modelcompression_tpu_torch/csrc/{EPILOGUE}.cu",
        "replaces": None,  # XLA fuses this epilogue for the JAX package
        "launches": launches["unpruned"][EPILOGUE],
        "main_launches": {m: c[EPILOGUE] for m, c in launches.items()},
        "shape": f"{epilogue['cfg']} batch {epilogue['batch']}, "
                 f"{f['launches']} conv outputs",
        "max_ulps_from_plain": epilogue["max_ulps_from_plain"],
        **{k: f[k] for k in ("ms", "device_ms", "bound_ms", "bound_by",
                             "roofline_pct", "plain_ms", "library_ms",
                             "library_device_ms")},
        "eval_launches": all_widths(eval_widths),
        "finetune_launches": all_widths(ft_widths),
        "families_launches": all_widths(fam_widths),
        "families_train_launches": all_widths(train_widths),
        "int8_launches": all_widths(int8_widths),
        "compress_launches": all_widths(cmp_widths),
        "parallel_launches": all_widths(par_widths),
        "tensor_parallel_launches": all_widths(tp_widths),
        "tools_launches": all_widths(tool_widths)})
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
        epilogue = phase_epilogue(torch)
        launches, main_lines = phase_main(torch, KERNELS, card)
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
            train_widths, train_topk = phase_families_train(
                torch, KERNELS, card, tmp, data)
            int8_widths, quantile_select = phase_int8(
                torch, KERNELS, card, tmp, data, weights, main_lines)
            cmp_widths = phase_compress(torch, KERNELS, card, tmp, data,
                                        weights, main_lines)
            par_widths = phase_parallel_deploy(torch, KERNELS, card, tmp,
                                               data, weights)
            tp_widths = phase_tensor_parallel(torch, KERNELS, card, tmp,
                                              data, weights)
            tool_widths, tool_cases, tool_topk = phase_tools(
                torch, KERNELS, card, tmp, data, weights)
        emit({"kernels": kernel_entries(cases, launches, topk,
                                        prune_launches, eval_widths,
                                        ft_widths, fam_widths, fam_topk,
                                        train_widths, train_topk,
                                        int8_widths, quantile_select,
                                        cmp_widths, par_widths, tp_widths,
                                        tool_widths, tool_cases,
                                        tool_topk, epilogue)})
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
