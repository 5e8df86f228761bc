"""Prune CLI, port of ``modelcompression_tpu/cli/prune.py``.

Modes:
  magnitude   per-layer unstructured magnitude masks at --sparsity
  global      one global |w| threshold at --sparsity
  l1_filter   L1-norm filter ranking at --fraction (or a per-layer
              --fractions schedule) + physical channel repack; writes a
              rewritten cfg beside the slimmed weights

The params are read on the CPU, moved to --device (default cuda; a
missing CUDA device is an error), masked or ranked there, and brought back
to be written. On a CUDA device the magnitude masks run the hand-written
top-k/mask kernels (ops/cuda_topk.py); --mask-backend reference selects
the stable-argsort definition instead. --sweep writes one file per point;
with --data it also evaluates each point's model on the dataset (mAP@50,
evaluation/pipeline.evaluate, batch --batch, on --device).

Not ported yet, each rejected with exit code 2: the modes lamp and
lowrank (ROADMAP Queue 1 item 6); bn_gamma, fpgm, taylor, --target-flops
and --tied group (item 5).

Examples:
  python -m modelcompression_tpu_torch.cli.prune \
      --cfg yolov2-voc.cfg --weights yolov2.weights \
      --mode magnitude --sparsity 0.75 --out pruned.weights
  python -m modelcompression_tpu_torch.cli.prune \
      --cfg yolov2-voc.cfg --weights yolov2.weights \
      --mode l1_filter --fraction 0.75 --out slim.weights \
      --out-cfg slim.cfg
"""

from __future__ import annotations

import argparse
import os
import sys

from modelcompression_tpu_torch.cli.common import (
    add_model_args, load_dataset, load_model, resolve_mask_backend,
)
from modelcompression_tpu_torch.compress import (
    DEFAULT_MASK_BACKEND, MASK_BACKENDS, apply_masks,
    l1_filter_keep_sets_scheduled, magnitude_mask_fn, mask_sparsity, repack,
    uniform_filter_fraction_keep_sets,
)
from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
from modelcompression_tpu_torch.models import (
    dump_cfg, num_params, params_to, save_weights,
)

_NOT_PORTED_MODES = {"lamp": 6, "lowrank": 6, "bn_gamma": 5, "fpgm": 5,
                     "taylor": 5}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--mode", default="magnitude",
                   choices=("magnitude", "global", "lamp", "l1_filter",
                            "bn_gamma", "fpgm", "taylor", "lowrank"),
                   help="lamp, lowrank, bn_gamma, fpgm and taylor are not "
                        "ported yet and are rejected")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the masks and scores are computed on "
                        "(default cuda; a missing CUDA device is an error)")
    p.add_argument("--sparsity", type=float, default=None,
                   help="target weight sparsity (magnitude/global modes)")
    p.add_argument("--fraction", type=float, default=None,
                   help="filter drop fraction (l1_filter mode)")
    p.add_argument("--fractions", default=None,
                   help="per-layer drop fractions for l1_filter mode as "
                        "'convidx:frac,convidx:frac' (e.g. '0:0.25,2:0.5'); "
                        "unlisted prunable convs use --fraction (or 0)")
    p.add_argument("--tied", default="protect", choices=("protect", "group"),
                   help="residual ([shortcut]) policy for filter modes: "
                        "'protect' keeps shortcut-tied convs unpruned; "
                        "'group' is not ported yet and is rejected")
    p.add_argument("--out", required=True, help="output .weights path")
    p.add_argument("--out-cfg", default=None,
                   help="rewritten .cfg path (l1_filter mode; magnitude "
                        "modes write the unchanged architecture)")
    p.add_argument("--mask-backend", default=DEFAULT_MASK_BACKEND,
                   choices=MASK_BACKENDS,
                   help="magnitude/global mask implementation: 'fused' "
                        "(default) and 'pallas' are both the hand-written "
                        "top-k/mask kernels on CUDA (their plain PyTorch "
                        "versions on the CPU); 'reference' is the "
                        "stable-argsort definition")
    p.add_argument("--use-pallas", action="store_true",
                   help="alias for --mask-backend pallas")
    p.add_argument("--sweep", default=None,
                   help="comma list of sparsities/fractions: prune at each "
                        "point and write <out stem>_<pct>.weights")
    # flags of the JAX CLI whose paths are not ported yet: parsed, so that
    # its command lines reach the rejection that names the ROADMAP item
    p.add_argument("--target-flops", type=float, default=None,
                   help="FLOP-budget filter allocation (not ported yet)")
    p.add_argument("--data", default=None,
                   help="dataset (.data file, VOCdevkit root or COCO json) "
                        "for sweep evaluation")
    p.add_argument("--image-set", default="test",
                   help="VOCdevkit image set for sweep evaluation")
    p.add_argument("--batch", type=int, default=8,
                   help="sweep evaluation batch size")
    for flag, kind, default in (("--score-batches", int, 8),
                                ("--score-seed", int, 0),
                                ("--min-filters", int, 1),
                                ("--score-norm", str, "l2"),
                                ("--energy", float, 0.9),
                                ("--rank", str, None),
                                ("--max-cost", float, 1.0)):
        p.add_argument(flag, type=kind, default=default,
                       help="used only by paths not ported yet")
    p.add_argument("--taylor-sq", action="store_true",
                   help="taylor mode (not ported yet)")
    return p


def _not_ported(args):
    """The reason a command line cannot run yet, or None."""
    item = _NOT_PORTED_MODES.get(args.mode)
    if item:
        what = f"--mode {args.mode}"
    elif args.target_flops is not None:
        item, what = 5, "--target-flops"
    elif args.tied == "group":
        item, what = 5, "--tied group"
    else:
        return None
    return (f"{what} is not ported to the PyTorch package yet "
            f"(ROADMAP Queue 1 item {item})")


def _magnitude(args, spec, dev_params, sparsity):
    """(pruned device params, masks, achieved sparsity)."""
    masks = magnitude_mask_fn(args.mode, args.mask_backend)(
        dev_params, spec, sparsity)
    return apply_masks(dev_params, masks), masks, mask_sparsity(masks)


def _write_cfg(path, spec):
    with open(path, "w") as f:
        f.write(dump_cfg(spec))


def _sweep(args, spec, params, seen, device) -> int:
    points = [float(x) for x in args.sweep.split(",") if x]
    for v in points:
        if not 0.0 <= v < 1.0:
            print(f"error: sweep point {v} out of [0, 1)", file=sys.stderr)
            return 2
    samples = names = None
    if args.data:
        samples, names = load_dataset(args)
    stem = os.path.splitext(args.out)[0]
    dev_params = params_to(params, device)
    rows = []
    for v in points:
        pct = int(round(v * 100))
        out = f"{stem}_{pct}.weights"
        if args.mode == "l1_filter":
            keep = uniform_filter_fraction_keep_sets(spec, dev_params, v,
                                                     tied=args.tied)
            out_spec, out_params = repack(spec, dev_params, keep)
            achieved = 1.0 - num_params(out_params) / num_params(params)
            _write_cfg(f"{stem}_{pct}.cfg", out_spec)
        else:
            out_spec = spec
            out_params, _, achieved = _magnitude(args, spec, dev_params, v)
        save_weights(out, out_spec, params_to(out_params, "cpu"), seen=seen)
        map50 = None
        if samples is not None:
            map50 = evaluate(out_params, out_spec, samples, names,
                             EvalConfig(batch_size=args.batch,
                                        device=args.device)).map50
        rows.append((v, achieved, map50))
        print(f"sweep {v:.0%}: achieved {achieved:.2%} -> {out}"
              + (f"  mAP@50 {map50 * 100:.2f}" if map50 is not None
                 else ""))
    print(f"{'point':>6} {'achieved':>9} {'mAP@50':>8}")
    for v, achieved, map50 in rows:
        print(f"{v:6.0%} {achieved:9.2%} "
              + (f"{map50 * 100:8.2f}" if map50 is not None else "      --"))
    return 0


def _parse_fractions(text):
    sched = {}
    for tok in text.split(","):
        if not tok.strip():
            continue
        idx, _, val = tok.partition(":")
        f = float(val)
        if not 0.0 <= f < 1.0:
            raise ValueError(f"fraction {f} out of [0, 1)")
        sched[int(idx)] = f
    return sched


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.mask_backend = resolve_mask_backend(args)
    why = _not_ported(args)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    spec, params, seen = load_model(args)
    n0 = num_params(params)

    if args.sweep:
        return _sweep(args, spec, params, seen, device)

    if args.mode in ("magnitude", "global"):
        if args.sparsity is None:
            print(f"error: --sparsity is required for {args.mode} mode",
                  file=sys.stderr)
            return 2
        if not 0.0 <= args.sparsity < 1.0:
            print(f"error: --sparsity must be in [0, 1), got "
                  f"{args.sparsity}", file=sys.stderr)
            return 2
        pruned, masks, achieved = _magnitude(
            args, spec, params_to(params, device), args.sparsity)
        save_weights(args.out, spec, params_to(pruned, "cpu"), seen=seen)
        print(f"{args.mode} prune: target sparsity {args.sparsity:.2%}, "
              f"achieved {achieved:.2%} over "
              f"{sum(m.numel() for m in masks.values())} weights")
        print(f"wrote {args.out}")
        if args.out_cfg:
            _write_cfg(args.out_cfg, spec)
            print(f"wrote {args.out_cfg} (architecture unchanged)")
        return 0

    # l1_filter: structured pruning + repack
    if args.fraction is None and args.fractions is None:
        print("error: --fraction or --fractions is required for l1_filter "
              "mode", file=sys.stderr)
        return 2
    if args.fraction is not None and not 0.0 <= args.fraction < 1.0:
        print(f"error: --fraction must be in [0, 1), got {args.fraction}",
              file=sys.stderr)
        return 2
    dev_params = params_to(params, device)
    if args.fractions is not None:
        try:
            keep = l1_filter_keep_sets_scheduled(
                dev_params, spec, _parse_fractions(args.fractions),
                default=args.fraction or 0.0)
        except ValueError as e:
            print(f"error: bad --fractions: {e}", file=sys.stderr)
            return 2
        what = f"per-layer schedule {args.fractions}"
    else:
        keep = uniform_filter_fraction_keep_sets(spec, dev_params,
                                                 args.fraction,
                                                 tied=args.tied)
        what = f"{args.fraction:.0%} of filters per prunable conv"
    slim_spec, slim_params = repack(spec, dev_params, keep)
    save_weights(args.out, slim_spec, params_to(slim_params, "cpu"),
                 seen=seen)
    print(f"{args.mode} prune: dropped {what}; params {n0 / 1e6:.1f}M -> "
          f"{num_params(slim_params) / 1e6:.1f}M")
    print(f"wrote {args.out}")
    out_cfg = args.out_cfg or os.path.splitext(args.out)[0] + ".cfg"
    _write_cfg(out_cfg, slim_spec)
    print(f"wrote {out_cfg} (slimmed architecture — use it for "
          "eval/fine-tune)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
