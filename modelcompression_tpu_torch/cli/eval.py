"""Eval CLI, port of ``modelcompression_tpu/cli/eval.py``: VOC mAP@50 for
a model on a dataset. Prints a per-class AP table and the mAP, optionally
dumping devkit-format detection files; ``--recall`` runs the darknet
recall audit instead.

Runs on --device (default cuda; a missing CUDA device is an error). The
default FAST precision BN-folds the model and runs conv1 + pool through
the tensor-core input-stage kernel; ``--precision bitmatch`` is the fp32
unfolded forward. ``.png`` images decode without cv2; other formats
(VOC's JPEG) and images not at the network size need cv2.

Not ported yet, each rejected with exit code 2 naming its ROADMAP item:
--int8, --qmodel, --cluster-bits, --save-qmodel, --save-cmodel, --cmodel
and --pack (Queue 1 item 6); --dp / --tp above 1 (item 7). Every NMS
variant of the JAX CLI runs: --exact-nms, --soft-nms (--soft-nms-sigma),
--diou-nms (--diou-beta), --nms-prefilter-impl bisect. [region] (YOLOv2)
and [yolo] (YOLOv3 / YOLOv4) cfgs evaluate alike.

Example:
  python -m modelcompression_tpu_torch.cli.eval --cfg yolov2-voc.cfg \\
      --weights yolov2.weights --data voc.data --batch 64 --dump-dir out/
"""

from __future__ import annotations

import argparse
import sys

from modelcompression_tpu_torch.cli.common import (
    add_data_args, add_model_args, add_parallel_args, load_dataset,
    load_model,
)
from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.core.precision import get_precision
from modelcompression_tpu_torch.evaluation import (
    EvalConfig, dump_detections, evaluate, evaluate_recall,
)

_NOT_PORTED = "not ported yet; rejected"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eval", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p, weights_required=False)
    add_data_args(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the model runs on (default cuda; a missing "
                        "CUDA device is an error)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.005,
                   help="confidence threshold")
    p.add_argument("--nms", type=float, default=0.45, help="NMS IoU")
    p.add_argument("--max-det", type=int, default=100)
    p.add_argument("--nms-prefilter", type=int, default=0,
                   help="class-agnostic top-N' candidate prefilter before "
                        "the per-class NMS sorts (0 = off, the mAP "
                        "default). Exact while <= N' candidates/image "
                        "clear --conf (overflow is reported)")
    p.add_argument("--nms-prefilter-impl", choices=("topk", "bisect"),
                   default="topk",
                   help="prefilter implementation: 'topk' (per-image "
                        "stable sort) or 'bisect' (sort-free batched "
                        "segmented select through the top-k kernels; "
                        "same exactness condition, evaluation/nms.py)")
    p.add_argument("--exact-nms", action="store_true",
                   help="exact greedy NMS over ALL candidates (no top-K "
                        "candidate prefilter; --max-det serial argmax "
                        "rounds per image-class, the mAP-audit switch)")
    p.add_argument("--soft-nms", choices=("linear", "gaussian"),
                   default=None,
                   help="Soft-NMS: decay overlapping scores instead of "
                        "erasing boxes (gaussian s*=exp(-iou^2/sigma), "
                        "linear s*=1-iou above --nms); excludes "
                        "--exact-nms/--nms-prefilter")
    p.add_argument("--soft-nms-sigma", type=float, default=0.5,
                   help="Gaussian soft-NMS temperature (default 0.5)")
    p.add_argument("--diou-nms", action="store_true",
                   help="DIoU-NMS: suppress on IoU - center-distance "
                        "penalty > --nms; composes with --exact-nms/"
                        "--nms-prefilter, excludes --soft-nms")
    p.add_argument("--diou-beta", type=float, default=1.0,
                   help="DIoU-NMS penalty exponent (rho^2/c^2)^beta "
                        "(darknet beta_nms; default 1.0, the paper form)")
    p.add_argument("--metric", choices=("07", "continuous"), default="07",
                   help="VOC AP protocol: 11-point (07) or all-point")
    p.add_argument("--map-iou", type=float, default=0.5,
                   help="AP matching IoU threshold (0.5 = the VOC/headline "
                        "protocol; e.g. 0.75 audits localization quality)")
    p.add_argument("--map-coco", action="store_true",
                   help="also report mAP@[.50:.95] (all-point AP over IoU "
                        "0.50:0.05:0.95) from the same detections — "
                        "host-side only, no extra device work")
    p.add_argument("--recall", action="store_true",
                   help="recall audit instead of mAP (darknet 'detector "
                        "recall'): objectness-only proposals, class-"
                        "agnostic NMS, per-GT best-IoU; prints cumulative "
                        "RPs/Img, avg IoU, and recall@--recall-iou. "
                        "Darknet's knobs were --conf 0.001 --nms 0.4")
    p.add_argument("--recall-iou", type=float, default=0.5,
                   help="IoU above which a ground-truth box counts as "
                        "recalled (darknet uses 0.5)")
    p.add_argument("--precision", default="fast",
                   choices=("fast", "bitmatch"),
                   help="bitmatch = fp32 with TF32 off and BN unfolded "
                        "(bit-faithful, slower)")
    p.add_argument("--no-letterbox", action="store_true",
                   help="stretch-resize instead of letterbox")
    p.add_argument("--continuous-iou", action="store_true",
                   help="use continuous-coordinate IoU for AP matching "
                        "instead of the VOC devkit's +1 inclusive-pixel "
                        "convention (the default)")
    p.add_argument("--dump-dir", default=None,
                   help="write per-class detection files here")
    p.add_argument("--int8", action="store_true",
                   help=f"post-training int8 inference ({_NOT_PORTED})")
    p.add_argument("--calib-images", type=int, default=64,
                   help="images used for int8 activation calibration")
    p.add_argument("--calib-quantile", type=float, default=None,
                   help="int8 calibration quantile (with --int8)")
    p.add_argument("--int8-layers", default="all",
                   help="which convs run int8 (with --int8)")
    p.add_argument("--save-qmodel", default=None, metavar="PATH",
                   help=f"save the int8 artifact ({_NOT_PORTED})")
    p.add_argument("--qmodel", default=None, metavar="PATH",
                   help=f"serve a saved int8 artifact ({_NOT_PORTED})")
    p.add_argument("--cluster-bits", type=int, default=None,
                   metavar="BITS",
                   help=f"weight sharing ({_NOT_PORTED})")
    p.add_argument("--save-cmodel", default=None, metavar="PATH",
                   help=f"save the weight-sharing artifact ({_NOT_PORTED})")
    p.add_argument("--pack", nargs="?", const="huffman", default=None,
                   choices=("huffman", "fixed"), metavar="METHOD",
                   help=f"entropy-code a saved artifact ({_NOT_PORTED})")
    p.add_argument("--cmodel", default=None, metavar="PATH",
                   help=f"serve a saved weight-sharing artifact "
                        f"({_NOT_PORTED})")
    add_parallel_args(p)
    return p


def _usage_error(args):
    """The JAX CLI's mutual-exclusion errors, in its order and words."""
    if args.exact_nms and args.nms_prefilter > 0:
        return ("--exact-nms and --nms-prefilter are mutually exclusive — "
                "the exact path runs greedy NMS over ALL candidates, so a "
                "prefilter would silently not apply")
    if args.soft_nms and (args.exact_nms or args.nms_prefilter > 0):
        return ("--soft-nms is mutually exclusive with --exact-nms/"
                "--nms-prefilter — those select variants of greedy erasure "
                "NMS, soft-NMS replaces the erasure rule itself")
    if args.soft_nms and args.diou_nms:
        return ("--soft-nms and --diou-nms are mutually exclusive — DIoU "
                "changes the greedy erasure criterion, soft-NMS replaces "
                "erasure with score decay")
    if args.qmodel and (args.int8 or args.save_qmodel):
        return ("--qmodel serves an already-quantized artifact; "
                "--int8/--save-qmodel (re)quantize from --weights — pick "
                "one direction")
    if args.save_qmodel and not args.int8:
        return ("--save-qmodel requires --int8 (it saves the "
                "calibrated+quantized model)")
    if args.save_cmodel and args.cluster_bits is None:
        return ("--save-cmodel requires --cluster-bits (it saves the "
                "clustered model)")
    if args.pack and not (args.save_cmodel or args.save_qmodel):
        return ("--pack entropy-codes a saved artifact; it requires "
                "--save-cmodel or --save-qmodel")
    if args.cmodel and (args.cluster_bits is not None or args.qmodel):
        return ("--cmodel serves an already-clustered artifact; it cannot "
                "combine with --cluster-bits or --qmodel")
    if args.qmodel and args.cluster_bits is not None:
        return ("--cluster-bits re-clusters f32 weights; a --qmodel "
                "artifact is already int8 — cluster before/instead of "
                "quantizing")
    if sum(map(bool, (args.weights, args.qmodel, args.cmodel))) != 1:
        # exactly one: with several given, one would be silently ignored
        return "exactly one of --weights, --qmodel or --cmodel is required"
    return None


def _not_ported(args):
    """The flag a command line needs that is not ported yet, with its
    ROADMAP item, or None."""
    for flag, on, item in (
            ("--int8", args.int8, 6), ("--qmodel", args.qmodel, 6),
            ("--cluster-bits", args.cluster_bits is not None, 6),
            ("--save-qmodel", args.save_qmodel, 6),
            ("--save-cmodel", args.save_cmodel, 6),
            ("--cmodel", args.cmodel, 6), ("--pack", args.pack, 6),
            ("--dp", args.dp > 1, 7), ("--tp", args.tp > 1, 7)):
        if on:
            return (f"{flag} is not ported to the PyTorch package yet "
                    f"(ROADMAP Queue 1 item {item})")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _usage_error(args) or _not_ported(args)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    resolve_device(args.device)  # no CUDA: raise before reading anything
    spec, params, _ = load_model(args)
    samples, names = load_dataset(args)
    if not samples:
        print("error: dataset is empty", file=sys.stderr)
        return 2
    precision = get_precision(args.precision)
    cfg = EvalConfig(
        batch_size=args.batch, conf_thresh=args.conf, nms_thresh=args.nms,
        max_detections=args.max_det, use_07_metric=(args.metric == "07"),
        map_iou=args.map_iou, coco_map=args.map_coco,
        letterbox=not args.no_letterbox, precision=precision,
        devkit_iou=not args.continuous_iou,
        fold_bn=(precision.name != "bitmatch"),
        exact_nms=args.exact_nms, nms_prefilter=args.nms_prefilter,
        nms_prefilter_impl=args.nms_prefilter_impl,
        soft_nms=args.soft_nms or "", soft_nms_sigma=args.soft_nms_sigma,
        diou_nms=args.diou_nms, diou_beta=args.diou_beta,
        device=args.device)
    if args.recall:
        if args.dump_dir or args.map_coco:
            print("error: --recall is an objectness-only audit — it "
                  "produces no per-class detections, so --dump-dir/"
                  "--map-coco do not apply", file=sys.stderr)
            return 2
        if args.exact_nms or args.nms_prefilter:
            print("error: --recall always uses the top-(--max-det) "
                  "class-agnostic proposal NMS (darknet detector recall "
                  "semantics); --exact-nms/--nms-prefilter do not apply "
                  "— raise --max-det to widen the proposal set",
                  file=sys.stderr)
            return 2
        if not 0.0 < args.recall_iou <= 1.0:
            print(f"error: --recall-iou must be in (0, 1], got "
                  f"{args.recall_iou}", file=sys.stderr)
            return 2
        rres = evaluate_recall(params, spec, samples, cfg,
                               recall_iou=args.recall_iou, progress=True)
        print(rres.summary())
        return 0
    res = evaluate(params, spec, samples, names, cfg)
    print(res.summary())
    if args.dump_dir:
        dump_detections(res, args.dump_dir)
        print(f"wrote detection dumps to {args.dump_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
