"""Detect CLI, port of ``modelcompression_tpu/cli/detect.py``: inference
with drawn boxes on one image (--image), a whole directory (--dir) or a
video file (--video), batched through the same serving step the eval
pipeline uses (normalize -> forward -> decode -> NMS -> source-pixel
boxes). [region] (YOLOv2) and [yolo] (YOLOv3 / YOLOv4) cfgs alike, with
every serving NMS flag.

Runs on --device (default cuda; a missing CUDA device is an error).
Reading, drawing and writing images and video use cv2. ``--qmodel``
serves an int8 artifact (``eval --int8 --save-qmodel`` or ``finetune
--qat --save-qmodel``, of either package) through
``compress.forward_quantized``; ``--cmodel`` a weight-sharing artifact
(``eval --cluster-bits N --save-cmodel``, of either package, packed or
not) as its reconstructed float32 params. ``--dp N`` (with --dir or
--video) splits each device batch over N devices of --device, the params
replicated, one step per shard (``parallel.data_parallel``).

Examples:
  python -m modelcompression_tpu_torch.cli.detect --cfg yolov2-voc.cfg \\
      --weights yolov2.weights --image dog.jpg --out prediction.png
  python -m modelcompression_tpu_torch.cli.detect --cfg yolov4-voc.cfg \\
      --weights yolov4.weights --dir frames/ --out-dir detections/ \\
      --batch 16 --deployment
  python -m modelcompression_tpu_torch.cli.detect --cfg yolov2-voc.cfg \\
      --weights yolov2.weights --video clip.avi --out-video pred.avi
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from modelcompression_tpu_torch.cli.common import (
    add_model_args, add_serving_nms_args, build_mesh, dispatch_padded_batch,
    fetch_batch, load_serving_model, prepare_serving,
    resolve_serving_eval_config, run_padded_batch, unpack_detections,
)
from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.data.preprocess import letterbox_host
from modelcompression_tpu_torch.data.voc import VOC_CLASSES, read_names
from modelcompression_tpu_torch.evaluation import make_eval_step
from modelcompression_tpu_torch.parallel import data_parallel, replicate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="detect", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p, weights_required=False)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the model runs on (default cuda; a missing "
                        "CUDA device is an error)")
    p.add_argument("--image", default=None)
    p.add_argument("--out", default="prediction.png")
    p.add_argument("--dir", default=None,
                   help="detect on every image in a directory, batched "
                        "through one serving step (pads the final partial "
                        "batch; annotated copies go to --out-dir)")
    p.add_argument("--out-dir", default="detections",
                   help="with --dir: output directory for drawn images")
    p.add_argument("--video", default=None,
                   help="detect on every frame of a video file, batched "
                        "through one serving step; the annotated video "
                        "goes to --out-video")
    p.add_argument("--out-video", default="prediction.avi",
                   help="with --video: output video path (.avi uses the "
                        "MJPG codec; other extensions try mp4v)")
    p.add_argument("--batch", type=int, default=16,
                   help="with --dir/--video: device batch size")
    p.add_argument("--dp", type=int, default=0,
                   help="with --dir/--video: split each device batch "
                        "over this many devices on a 'data' mesh axis "
                        "(params replicated, one step per shard — same "
                        "mechanism as serve/eval --dp). --batch must "
                        "divide evenly. 0 = single device (no mesh); any "
                        "N >= 1 builds an N-device mesh and requires "
                        "--dir/--video")
    add_serving_nms_args(p)
    p.add_argument("--names", default=None, help=".names file")
    p.add_argument("--qmodel", default=None, metavar="PATH",
                   help="serve a saved int8 deployment artifact "
                        "(eval --int8 --save-qmodel) instead of --weights")
    p.add_argument("--cmodel", default=None, metavar="PATH",
                   help="serve a saved weight-sharing artifact "
                        "(eval --cluster-bits N --save-cmodel) instead "
                        "of --weights")
    return p


def _draw_detections(img_bgr, sel, scores, valid, names, w, h,
                     quiet=False) -> int:
    """Draw one image's (C, K, 4) source-pixel boxes in place (highest
    score first); returns the number drawn."""
    import cv2
    dets = unpack_detections(sel, scores, valid, w, h)
    for d in dets:
        ci = d["class_id"]
        x1, y1, x2, y2 = (int(min(v, lim - 1)) for v, lim in
                          zip(d["box"], (w, h, w, h)))
        color = tuple(int(c) for c in np.random.default_rng(ci)
                      .integers(60, 255, 3))
        cv2.rectangle(img_bgr, (x1, y1), (x2, y2), color, 2)
        label = f"{names[ci]} {d['score']:.2f}"
        cv2.putText(img_bgr, label, (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
        if not quiet:
            print(f"{names[ci]}: {d['score']:.3f} "
                  f"[{x1}, {y1}, {x2}, {y2}]")
    return len(dets)


def _detect_dir(args, spec, folded, step, names) -> int:
    """Directory mode: letterbox on the host, run the serving step at a
    fixed batch (the final partial batch padded by repetition; padded
    rows are not read back). Pipelined: batch i is enqueued before batch
    i-1 is fetched, drawn and written."""
    import cv2

    exts = (".jpg", ".jpeg", ".png", ".bmp")
    paths = sorted(
        os.path.join(args.dir, f) for f in os.listdir(args.dir)
        if f.lower().endswith(exts))
    if not paths:
        print(f"error: no images in {args.dir}", file=sys.stderr)
        return 2
    os.makedirs(args.out_dir, exist_ok=True)
    net_h, net_w = spec.net.height, spec.net.width
    b = max(1, args.batch)
    total = n_images = 0

    def drain(pending):
        nonlocal total, n_images
        kept, imgs, ws, hs, dev = pending
        sel, sc, valid = fetch_batch(dev)
        for j, (pth, im) in enumerate(zip(kept, imgs)):
            n = _draw_detections(im, sel[j], sc[j], valid[j], names,
                                 int(ws[j]), int(hs[j]), quiet=True)
            out = os.path.join(args.out_dir, os.path.basename(pth))
            cv2.imwrite(out, im)
            print(f"{pth}: {n} detections -> {out}")
            total += n
            n_images += 1

    pending = None
    for i in range(0, len(paths), b):
        imgs, canvases, ws, hs, kept = [], [], [], [], []
        for pth in paths[i:i + b]:
            im = cv2.imread(pth, cv2.IMREAD_COLOR)
            if im is None:
                print(f"warning: cannot read {pth}, skipped",
                      file=sys.stderr)
                continue
            canvas, _, _, _ = letterbox_host(im[:, :, ::-1], net_h, net_w)
            imgs.append(im)
            canvases.append(canvas)
            hs.append(float(im.shape[0]))
            ws.append(float(im.shape[1]))
            kept.append(pth)
        if not kept:
            continue
        dev = dispatch_padded_batch(step, folded, canvases, ws, hs, b)
        if pending is not None:
            drain(pending)
        pending = (kept, imgs, ws, hs, dev)
    if pending is not None:
        drain(pending)
    print(f"{total} detections over {n_images} images -> {args.out_dir}")
    return 0


def _detect_video(args, spec, folded, step, names) -> int:
    """Video mode: read frames, letterbox on the host, run the serving
    step at a fixed batch, write the annotated frames. Same padded final
    batch and pipelining as --dir."""
    import cv2

    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        print(f"error: cannot open video {args.video}", file=sys.stderr)
        return 2
    fps = cap.get(cv2.CAP_PROP_FPS)
    fps = float(fps) if fps and fps > 0 else 25.0
    ext = os.path.splitext(args.out_video)[1].lower()
    codec = "MJPG" if ext == ".avi" else "mp4v"
    fourcc = cv2.VideoWriter_fourcc(*codec)
    net_h, net_w = spec.net.height, spec.net.width
    b = max(1, args.batch)
    writer = None
    size0 = None
    total = frames = 0
    t0 = time.time()

    def drain(pending):
        """Fetch, draw and write one dispatched batch; returns an error
        code (0 = ok)."""
        nonlocal writer, size0, total, frames
        ims, ws, hs, dev = pending
        sel, sc, valid = fetch_batch(dev)
        for j, im in enumerate(ims):
            total += _draw_detections(im, sel[j], sc[j], valid[j], names,
                                      int(ws[j]), int(hs[j]), quiet=True)
            if writer is None:
                size0 = (im.shape[1], im.shape[0])
                writer = cv2.VideoWriter(args.out_video, fourcc, fps, size0)
                if not writer.isOpened():
                    print(f"error: cannot open writer for "
                          f"{args.out_video} (codec {codec})",
                          file=sys.stderr)
                    return 2
            if (im.shape[1], im.shape[0]) != size0:
                print("error: variable frame size mid-stream",
                      file=sys.stderr)
                return 2
            writer.write(im)
            frames += 1
        return 0

    pending = None
    rc = 0
    try:
        while rc == 0:
            ims = []
            while len(ims) < b:
                ok, im = cap.read()
                if not ok:
                    break
                ims.append(im)
            if not ims:
                break
            canvases, ws, hs = [], [], []
            for im in ims:
                canvas, _, _, _ = letterbox_host(im[:, :, ::-1], net_h,
                                                 net_w)
                canvases.append(canvas)
                hs.append(float(im.shape[0]))
                ws.append(float(im.shape[1]))
            dev = dispatch_padded_batch(step, folded, canvases, ws, hs, b)
            if pending is not None:
                rc = drain(pending)
            pending = (ims, ws, hs, dev)
        if rc == 0 and pending is not None:
            rc = drain(pending)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if rc:
        return rc
    if writer is None:
        print(f"error: no frames decoded from {args.video}",
              file=sys.stderr)
        return 2
    wall = time.time() - t0
    print(f"{total} detections over {frames} frames "
          f"({frames / wall:.1f} fps incl. video IO) -> {args.out_video}")
    return 0


def main(argv=None) -> int:
    import cv2
    args = build_parser().parse_args(argv)
    if sum(map(bool, (args.weights, args.qmodel, args.cmodel))) != 1:
        print("error: exactly one of --weights, --qmodel or --cmodel is "
              "required", file=sys.stderr)
        return 2
    if sum(map(bool, (args.image, args.dir, args.video))) != 1:
        print("error: exactly one of --image, --dir or --video is "
              "required", file=sys.stderr)
        return 2
    try:
        resolve_device(args.device)  # no CUDA: fail before reading
        spec, params, quantized = load_serving_model(args)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    names = read_names(args.names) if args.names else list(VOC_CLASSES)
    if len(names) != spec.classes:
        names = [f"class{i}" for i in range(spec.classes)]
    cfg = resolve_serving_eval_config(args, spec=spec)
    folded, cfg = prepare_serving(spec, params, quantized, cfg)
    step = make_eval_step(spec, cfg)

    # dp >= 1 takes the mesh path, as in the JAX CLI: --dp 1 gets the same
    # mode and divisibility checks as --dp 2
    if args.dp >= 1:
        if not (args.dir or args.video):
            print("error: --dp applies to the batched --dir/--video "
                  "modes only", file=sys.stderr)
            return 2
        if args.batch % args.dp:
            print(f"error: --batch {args.batch} must be divisible by "
                  f"--dp {args.dp}", file=sys.stderr)
            return 2
        mesh, _ = build_mesh(args)
        folded = replicate(folded, mesh)
        step = data_parallel(step, mesh)

    if args.dir:
        return _detect_dir(args, spec, folded, step, names)
    if args.video:
        return _detect_video(args, spec, folded, step, names)

    img = cv2.imread(args.image, cv2.IMREAD_COLOR)
    if img is None:
        print(f"error: cannot read image {args.image}", file=sys.stderr)
        return 2
    h, w = img.shape[:2]
    canvas, _, _, _ = letterbox_host(img[:, :, ::-1], spec.net.height,
                                     spec.net.width)
    sel, out_scores, valid = run_padded_batch(
        step, folded, [canvas], [float(w)], [float(h)], 1)
    n_drawn = _draw_detections(img, sel[0], out_scores[0], valid[0], names,
                               w, h)
    cv2.imwrite(args.out, img)
    print(f"{n_drawn} detections -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
