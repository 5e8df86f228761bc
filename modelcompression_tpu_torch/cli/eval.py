"""Eval CLI, port of ``modelcompression_tpu/cli/eval.py``: VOC mAP@50 for
a model on a dataset. Prints a per-class AP table and the mAP, optionally
dumping devkit-format detection files; ``--recall`` runs the darknet
recall audit instead.

Runs on --device (default cuda; a missing CUDA device is an error). The
default FAST precision BN-folds the model and runs conv1 + pool through
the tensor-core input-stage kernel; ``--precision bitmatch`` is the fp32
unfolded forward. ``.png`` images decode without cv2; other formats
(VOC's JPEG) and images not at the network size need cv2.

``--int8`` quantizes the BN-folded model after the JAX CLI's recipe
(compress/quantize.py): per-tensor activation scales calibrated on the
first --calib-images images (absmax, or --calib-quantile through the
radix-select kernel on CUDA), every conv int8 or the --int8-layers subset
(the rest bf16); on CUDA each int8 conv is cuBLASLt's int8 GEMM.
``--save-qmodel`` writes the int8 artifact, ``--qmodel`` serves one
(written by either package). ``--cluster-bits N`` clusters each conv's
weights into a 2^N-entry k-means codebook on the host
(compress/codebook.py) and evaluates the reconstructed model;
``--save-cmodel`` writes that artifact (``--pack huffman|fixed``
entropy-codes its codes, or the int8 weights of ``--save-qmodel``), and
``--cmodel`` serves one through the unchanged FAST path (input-stage
kernel included). ``--dp N`` evaluates data-parallel over N devices of
--device in this process (one step per shard, the results equal to one
device's; on the CPU every shard runs on the host); ``--tp M`` builds
the (max(N, 1), M) mesh and replicates the model over its model axis,
as the JAX CLI does, with the same results. Every NMS variant
of the JAX CLI runs: --exact-nms, --soft-nms (--soft-nms-sigma),
--diou-nms (--diou-beta), --nms-prefilter-impl bisect. [region] (YOLOv2)
and [yolo] (YOLOv3 / YOLOv4) cfgs evaluate alike.

Example:
  python -m modelcompression_tpu_torch.cli.eval --cfg yolov2-voc.cfg \\
      --weights yolov2.weights --data voc.data --batch 64 --dump-dir out/
"""

from __future__ import annotations

import argparse
import os
import sys

from modelcompression_tpu_torch.cli.common import (
    add_data_args, add_model_args, add_parallel_args, build_mesh,
    load_dataset, load_serving_model, prep_calibration, prepare_serving,
)
from modelcompression_tpu_torch.compress import (
    cluster_network, quantize_from_batches, reconstruct, save_cmodel,
    save_qmodel,
)
from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.core.precision import get_precision
from modelcompression_tpu_torch.evaluation import (
    EvalConfig, dump_detections, evaluate, evaluate_recall,
)
from modelcompression_tpu_torch.models import fold_batchnorm, params_to

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
                   help="post-training int8 inference "
                        "(compress/quantize.py): per-channel int8 "
                        "weights, per-tensor int8 activations calibrated "
                        "on the first --calib-images eval images. "
                        "Incompatible with --precision bitmatch")
    p.add_argument("--calib-images", type=int, default=64,
                   help="images used for int8 activation calibration")
    p.add_argument("--calib-quantile", type=float, default=None,
                   help="calibrate activation scales at this quantile of "
                        "|activation| instead of the max (e.g. 0.9999 "
                        "sheds single-pixel outliers)")
    p.add_argument("--int8-layers", default="all",
                   help="which convs run int8 (hybrid mode): 'all', "
                        "'auto' (min(Cin,Cout) >= 128), 'auto:K' for "
                        "another channel threshold, or explicit "
                        "comma-separated layer indices; the rest run "
                        "bf16")
    p.add_argument("--save-qmodel", default=None, metavar="PATH",
                   help="with --int8: save the calibrated and quantized "
                        "model as one standalone artifact (.npz with the "
                        "arch cfg embedded, the JAX package's format)")
    p.add_argument("--qmodel", default=None, metavar="PATH",
                   help="serve a saved int8 artifact (--save-qmodel) "
                        "instead of --weights, with no recalibration")
    p.add_argument("--cluster-bits", type=int, default=None,
                   metavar="BITS",
                   help="weight sharing: replace each conv's weights with "
                        "a per-layer k-means codebook of 2^BITS shared "
                        "values (pruned zeros stay exact), then evaluate "
                        "the reconstructed model")
    p.add_argument("--save-cmodel", default=None, metavar="PATH",
                   help="with --cluster-bits: save the weight-sharing "
                        "artifact (.npz with codes + codebooks + the arch "
                        "cfg; the JAX package's format)")
    p.add_argument("--pack", nargs="?", const="huffman", default=None,
                   choices=("huffman", "fixed"), metavar="METHOD",
                   help="entropy-code the saved artifact's code tensors "
                        "(--save-cmodel) or int8 weights (--save-qmodel): "
                        "'huffman' (default) canonical-Huffman-codes "
                        "them; 'fixed' bit-packs to ceil(log2 K) bits. "
                        "Loading is transparent")
    p.add_argument("--cmodel", default=None, metavar="PATH",
                   help="serve a saved weight-sharing artifact "
                        "(--save-cmodel) instead of --weights; the "
                        "reconstruction is exact")
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


def _cluster(args, spec, params):
    """--cluster-bits: the reconstructed params of the clustered model,
    written to --save-cmodel when asked; raises ValueError on bad bits."""
    cmodel = cluster_network(params, spec, bits=args.cluster_bits)
    params = reconstruct(cmodel)
    print(f"weight sharing: {args.cluster_bits}-bit codebooks "
          f"(<= {1 << args.cluster_bits} shared values per conv)",
          file=sys.stderr)
    if args.save_cmodel:
        save_cmodel(args.save_cmodel, cmodel, spec, pack=args.pack)
        n_w = sum(int(e["codes"].size) for e in cmodel.values()
                  if "codes" in e)
        size = os.path.getsize(args.save_cmodel)
        print(f"wrote weight-sharing artifact to {args.save_cmodel} "
              f"({size / 1e6:.2f} MB"
              + (f", {size * 8 / max(n_w, 1):.2f} bits/weight "
                 f"incl. f32 vectors+container; pack={args.pack}"
                 if args.pack else "") + ")",
              file=sys.stderr)
    return params


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _usage_error(args)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    resolve_device(args.device)  # no CUDA: raise before reading anything
    try:
        spec, params, quantized = load_serving_model(args)
        if args.cluster_bits is not None:
            params = _cluster(args, spec, params)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    samples, names = load_dataset(args)
    if not samples:
        print("error: dataset is empty", file=sys.stderr)
        return 2
    precision = get_precision(args.precision)
    if (args.int8 or args.qmodel) and precision.name == "bitmatch":
        print("error: --int8/--qmodel is a quantized path; it cannot "
              "bit-match (--precision bitmatch)", file=sys.stderr)
        return 2
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
    if args.int8:
        try:
            int8_sel, chunks, n = prep_calibration(
                spec, samples, args.calib_images, args.int8_layers,
                letterbox=not args.no_letterbox, what="int8")
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        n_sel = "all" if int8_sel is None else str(len(int8_sel))
        print(f"int8: calibrating activation scales on {n} images "
              f"({n_sel} convs quantized)...", file=sys.stderr)
        folded = params_to(fold_batchnorm(params, spec),
                           resolve_device(args.device))
        params = quantize_from_batches(
            folded, spec, chunks, quantile=args.calib_quantile,
            int8_layers=int8_sel)
        quantized = True
        if args.save_qmodel:
            save_qmodel(args.save_qmodel, params, spec, pack=args.pack)
            print(f"wrote int8 deployment artifact to {args.save_qmodel}",
                  file=sys.stderr)
    if quantized:
        params, cfg = prepare_serving(spec, params, True, cfg)
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
        if args.dp > 1 or args.tp > 1:
            print("error: --recall runs single-device; --dp/--tp do not "
                  "apply", file=sys.stderr)
            return 2
        if not 0.0 < args.recall_iou <= 1.0:
            print(f"error: --recall-iou must be in (0, 1], got "
                  f"{args.recall_iou}", file=sys.stderr)
            return 2
        rres = evaluate_recall(params, spec, samples, cfg,
                               recall_iou=args.recall_iou, progress=True)
        print(rres.summary())
        return 0
    try:
        mesh, _ = build_mesh(args)
    except ValueError as e:  # a mesh wider than the devices
        print(f"error: {e}", file=sys.stderr)
        return 2
    if mesh is not None and args.batch % mesh.shape["data"]:
        print(f"error: --batch {args.batch} must be divisible by "
              f"--dp {mesh.shape['data']}", file=sys.stderr)
        return 2
    res = evaluate(params, spec, samples, names, cfg, mesh=mesh)
    print(res.summary())
    if args.dump_dir:
        dump_detections(res, args.dump_dir)
        print(f"wrote detection dumps to {args.dump_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
