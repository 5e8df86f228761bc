"""Export CLI, port of ``modelcompression_tpu/cli/export.py``: package the
serving step as a ``torch.export`` program (``.pt2``) with the weights
baked in as constants. Serving the artifact needs PyTorch only: no weights
file and no code from this repo.

What gets exported is the serving step eval and detect run —
normalize -> forward -> decode -> NMS -> source-pixel coordinate mapping
(``evaluation/pipeline.make_eval_step``) — traced with
``torch.export.export(..., strict=False)`` for one device
(``--platforms``: ``cuda`` or ``cpu``). The step is the JAX export's: its
``EvalConfig`` defaults, so no fused input stage (a ctypes kernel cannot
be traced, and the JAX export's graph has none) and no class-agnostic
prefilter.

The export is verified before the CLI returns: the artifact is loaded
back with ``torch.export.load`` and run against the live step on a random
batch on the export's device; at ``bitmatch`` every output must agree at
the JAX CLI's tolerance (rtol 1e-5, atol 1e-4), at ``fast`` the agreement
is reported (advisory), as in the JAX CLI.

``--tflite`` / ``--tflite-quantize`` and a ``tpu`` platform have no
PyTorch form (no TensorFlow Lite converter ships with PyTorch) and exit 2.

Example:
  python -m modelcompression_tpu_torch.cli.export --cfg slim.cfg \\
      --weights slim.weights --out slim.pt2 --batch 1 --conf 0.25

Serving:
  m = torch.export.load("slim.pt2").module()
  boxes, scores, valid, n_cand, n_any = m(images_u8, widths, heights)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from modelcompression_tpu_torch.cli.common import (
    add_model_args, load_serving_model, prepare_serving,
)
from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.core.precision import BITMATCH, FAST
from modelcompression_tpu_torch.evaluation import EvalConfig, make_eval_step

OUTPUT_NAMES = ("boxes", "scores", "valid", "n_cand", "n_any")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="export", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p, weights_required=False)
    p.add_argument("--qmodel", default=None, metavar="PATH",
                   help="export from an int8 deployment artifact instead "
                        "of --weights (int8 grids baked into the graph)")
    p.add_argument("--cmodel", default=None, metavar="PATH",
                   help="export from a weight-sharing artifact instead "
                        "of --weights")
    p.add_argument("--out", required=True, help="output .pt2 file")
    p.add_argument("--batch", type=int, default=1,
                   help="the exported program's batch size")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--nms", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=50,
                   help="top-K detections per class")
    p.add_argument("--platforms", default="cuda",
                   help="the artifact's device: 'cuda' (default, the "
                        "port's device rule) or 'cpu'; one per artifact")
    p.add_argument("--tflite", action="store_true",
                   help="TensorFlow Lite flatbuffer: no PyTorch form "
                        "(exits 2)")
    p.add_argument("--tflite-quantize", default="none",
                   choices=("none", "dynamic"),
                   help="TFLite dynamic-range quantization: no PyTorch "
                        "form (exits 2)")
    p.add_argument("--precision", default=None,
                   choices=("bitmatch", "fast"),
                   help="compute precision baked into the graph: "
                        "'bitmatch' (fp32, tight verification; the "
                        "--weights default) or 'fast' (bf16 convs; "
                        "verification is advisory). --qmodel artifacts "
                        "bake the hybrid's own bf16 float convs, so "
                        "bitmatch is not available there")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the reload-and-compare check")
    return p


class _Serving(torch.nn.Module):
    """The serving step over fixed params: forward(images uint8 (B, H, W,
    3), width (B,), height (B,)) -> the step's five outputs. The params
    are plain attributes, not parameters or buffers, so the export
    captures them as constants."""

    def __init__(self, step, params):
        super().__init__()
        self.step = step
        self.params = params

    def forward(self, images, width, height):
        return tuple(self.step(self.params, images, width, height))


def _usage_error(args) -> str | None:
    """The JAX CLI's checks, in its order, then the options that have no
    PyTorch form."""
    if sum(map(bool, (args.weights, args.qmodel, args.cmodel))) != 1:
        return "exactly one of --weights, --qmodel or --cmodel is required"
    if args.batch < 1:
        return f"--batch must be >= 1, got {args.batch}"
    if args.tflite_quantize != "none" and not args.tflite:
        return "--tflite-quantize only applies with --tflite"
    if args.tflite:
        return ("--tflite has no PyTorch form: it needs a TensorFlow Lite "
                "converter, which PyTorch does not ship; export the .pt2 "
                "program instead")
    platforms = [s.strip() for s in args.platforms.split(",") if s.strip()]
    if "tpu" in platforms:
        return ("--platforms tpu has no PyTorch form: the artifact runs "
                "on 'cuda' or 'cpu'")
    if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
        return (f"--platforms takes one of 'cuda' or 'cpu' (a .pt2 "
                f"program is traced for one device), got {args.platforms!r}")
    return None


def _random_batch(b, net_h, net_w, device):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (b, net_h, net_w, 3), dtype=np.uint8)
    return (torch.from_numpy(images).to(device),
            torch.full((b,), float(net_w), device=device),
            torch.full((b,), float(net_h), device=device))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _usage_error(args)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    device = resolve_device(args.platforms.strip())
    try:
        spec, params, quantized = load_serving_model(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if quantized and args.precision == "bitmatch":
        print("error: --precision bitmatch is not available with "
              "--qmodel (the artifact's hybrid float convs are bf16); "
              "omit --precision or use --weights", file=sys.stderr)
        return 2
    prec_name = args.precision or ("fast" if quantized else "bitmatch")
    cfg = EvalConfig(conf_thresh=args.conf, nms_thresh=args.nms,
                     max_detections=args.max_det,
                     precision=BITMATCH if prec_name == "bitmatch" else FAST,
                     fuse_input_stage=False, device=device.type)
    served, cfg = prepare_serving(spec, params, quantized, cfg)
    step = make_eval_step(spec, cfg)
    module = _Serving(step, served)
    b, net_h, net_w = args.batch, spec.net.height, spec.net.width
    example = _random_batch(b, net_h, net_w, device)
    # the live step runs first: its reference outputs for the check, and
    # its constant caches (anchors) filled with real tensors, which the
    # trace then finds instead of caching its own fake ones
    want = [t.cpu().numpy() for t in module(*example)]

    t0 = time.perf_counter()
    program = torch.export.export(module, example, strict=False)
    torch.export.save(program, args.out)
    n_nodes = len(program.graph.nodes)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"batch {b}, {net_h}x{net_w}, device {device.type}, "
          f"{'int8 qmodel' if quantized else 'f32'} weights baked in, "
          f"{prec_name} compute, {n_nodes} graph nodes, "
          f"{time.perf_counter() - t0:.1f}s)")
    if args.no_verify:
        return 0

    loaded = torch.export.load(args.out).module()
    with torch.inference_mode():
        got = [t.cpu().numpy() for t in loaded(*example)]
    if prec_name == "fast":
        # bf16 graphs: near-threshold detections may flip rows, so report
        # the drift instead of row-for-row equality
        agree = float(np.mean(got[2] == want[2]))
        sdiff = float(np.max(np.abs(got[1] - want[1])))
        print(f"verify (fast/bf16, advisory): valid-flag agreement "
              f"{agree:.2%}, max score drift {sdiff:.2e}")
        return 0
    for name, g, w in zip(OUTPUT_NAMES, got, want):
        if not np.allclose(g, w, rtol=1e-5, atol=1e-4):
            diff = np.max(np.abs(g.astype(np.float64) - w.astype(np.float64)))
            print(f"error: verify mismatch on {name}: max diff {diff}",
                  file=sys.stderr)
            return 1
    print(f"verify ok: the loaded .pt2 == the live step on a random batch "
          f"({int(got[2].sum())} detections, {device.type})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
