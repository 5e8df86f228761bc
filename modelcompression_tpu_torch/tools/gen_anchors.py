"""Anchor-prior k-means (the darknet gen_anchors workflow): cluster the
training set's box shapes into ``--num`` anchor priors in CELL units (the
``[region] anchors=`` convention) using the IoU distance
d(box, centroid) = 1 - IoU(shape-only): Euclidean k-means over-weights
large boxes, and IoU k-means is what the YOLOv2 paper's priors were built
with. Pure numpy on the host, deterministic (a few thousand (w, h) pairs
is host-scale work).

Usage:
  python -m modelcompression_tpu_torch.tools.gen_anchors --data voc.data \\
      [--num 5] [--net-size 416]
Prints the ready-to-paste ``anchors = ...`` cfg line and the mean
best-anchor IoU (the clustering quality number to compare prior sets).

``--pixels`` emits NETWORK-INPUT-PIXEL anchors, the ``[yolo]``
convention (YOLOv3 family): same clustering, the units just stay at
net-size scale instead of dividing by the stride. Use ``--num 9`` for the
canonical 3-scale x 3-anchor v3 layout (assign the 3 smallest to the
finest head's mask, etc.).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def box_shapes(samples, net_size: int, pixels: bool = False) -> np.ndarray:
    """(N, 2) box (w, h) in cell units at net_size (stride 32), or in
    network-input pixels when ``pixels`` (the [yolo] convention)."""
    cells = float(net_size) if pixels else net_size / 32.0
    rows = [s.labels[:, 3:5] * cells for s in samples if len(s.labels)]
    if not rows:
        raise SystemExit("error: dataset has no boxes")
    wh = np.concatenate(rows, 0).astype(np.float64)
    return wh[(wh > 0).all(1)]


def shape_iou(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Shape-only IoU of (N, 2) boxes vs (K, 2) anchors -> (N, K)."""
    inter = (np.minimum(wh[:, None, 0], anchors[None, :, 0])
             * np.minimum(wh[:, None, 1], anchors[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] \
        + (anchors[:, 0] * anchors[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_iou(wh: np.ndarray, k: int, seed: int = 0,
               iters: int = 300) -> np.ndarray:
    """(k, 2) anchors, area-sorted: Lloyd iterations under the shape-IoU
    assignment with a per-cluster median update, from ``k`` boxes drawn
    with ``seed``."""
    rng = np.random.default_rng(seed)
    anchors = wh[rng.choice(len(wh), size=k, replace=len(wh) < k)].copy()
    assign = None
    for _ in range(iters):
        new_assign = shape_iou(wh, anchors).argmax(1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            members = wh[assign == j]
            if len(members):
                # darknet-lineage convention: median per cluster (robust
                # to the long tail of box sizes)
                anchors[j] = np.median(members, axis=0)
    order = np.argsort(anchors[:, 0] * anchors[:, 1])
    return anchors[order]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True,
                   help=".data file (train=) or VOCdevkit root")
    p.add_argument("--image-set", default="trainval")
    p.add_argument("--num", type=int, default=5)
    p.add_argument("--net-size", type=int, default=416)
    p.add_argument("--pixels", action="store_true",
                   help="emit network-input-pixel anchors (the [yolo]/"
                        "YOLOv3 convention) instead of [region] cell units")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the clustering runs on the "
                        "host either way, a missing card is an error as in "
                        "every command line")
    args = p.parse_args(argv)

    from modelcompression_tpu_torch.cli.common import load_train_dataset
    from modelcompression_tpu_torch.core.device import resolve_device
    resolve_device(args.device)
    samples, _ = load_train_dataset(args)
    wh = box_shapes(samples, args.net_size, pixels=args.pixels)
    anchors = kmeans_iou(wh, args.num, seed=args.seed)
    mean_iou = shape_iou(wh, anchors).max(1).mean()
    unit = "px" if args.pixels else "cells"
    print(f"# {len(wh)} boxes, {args.num} anchors ({unit}), net "
          f"{args.net_size}: mean best-anchor IoU {mean_iou:.4f}")
    print("anchors = " + ",  ".join(
        f"{w:.5g},{h:.5g}" for w, h in anchors))
    return 0


if __name__ == "__main__":
    sys.exit(main())
