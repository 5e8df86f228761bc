"""VOC mAP (port of ``modelcompression_tpu/evaluation/voc_map.py``, pure
numpy, so its results equal the JAX package's).

Per class: sort detections by confidence, match to ground truth at
IoU >= the threshold (greedy, each GT matched at most once, "difficult"
GT ignored: neither rewarded nor penalized), build the precision/recall
curve, integrate AP. ``use_07_metric=True`` is the 11-point VOC2007
devkit protocol; False is all-point integration (post-2010). Every
reported number should state which was used.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Detection:
    image_id: str
    score: float
    box: Tuple[float, float, float, float]  # x1, y1, x2, y2


@dataclasses.dataclass
class GroundTruth:
    image_id: str
    box: Tuple[float, float, float, float]
    difficult: bool = False


def _iou_np(box: np.ndarray, boxes: np.ndarray,
            inclusive: float = 0.0) -> np.ndarray:
    """IoU of one box against many. ``inclusive=1.0`` applies the VOC
    devkit's +1 inclusive-pixel convention (widths/heights computed as
    x2-x1+1 on integer pixel coordinates, as the canonical voc_eval.py
    does); 0.0 is the continuous-coordinate convention."""
    k = inclusive
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1 + k, 0) * np.maximum(y2 - y1 + k, 0)
    area = (box[2] - box[0] + k) * (box[3] - box[1] + k)
    areas = (boxes[:, 2] - boxes[:, 0] + k) * (boxes[:, 3] - boxes[:, 1] + k)
    union = area + areas - inter
    return np.where(union > 0, inter / union, 0.0)


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = True) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    # all-point: envelope the precision curve, integrate over recall steps
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _box_area(box, k: float) -> float:
    return (max(box[2] - box[0] + k, 0.0) * max(box[3] - box[1] + k, 0.0))


def class_ap(detections: Sequence[Detection],
             ground_truths: Sequence[GroundTruth],
             iou_thresh: float = 0.5,
             use_07_metric: bool = True,
             devkit_iou: bool = False,
             area_range: Tuple[float, float] = None) -> float:
    """AP for one class over a whole dataset.

    ``devkit_iou=True`` uses the VOC devkit's +1 inclusive-pixel IoU
    (boxes in pixel coordinates — what evaluate() produces); False keeps
    the continuous convention (unit-agnostic, e.g. normalized boxes).

    ``area_range=(lo, hi)`` restricts the AP to objects with
    lo <= box area <= hi (pycocotools' area-band semantics, INCLUSIVE
    upper bound like its ``aRng`` check — a box of exactly 32² px² lands
    in both adjacent bands, as it does there): out-of-band GT are IGNORED
    exactly like ``difficult`` (excluded from recall's denominator,
    matches neither rewarded nor penalized), and an UNMATCHED detection
    whose own area is out of band is ignored rather than counted as a
    false positive (matched detections are never area-ignored). Areas use
    the same +1 convention as the IoU choice. In band mode matching
    prefers the best UNMATCHED NON-ignored GT above the IoU threshold
    before falling back to the plain argmax (pycocotools' preference:
    it skips matched GTs and prefers non-ignored ones), so an in-band GT
    is not left unmatched just because a difficult/out-of-band GT
    overlaps slightly more. Without ``area_range`` the match is the
    canonical voc_eval.py plain argmax — the headline VOC protocol is
    unchanged (a det whose best-IoU GT is difficult stays ignored, as
    the devkit scores it).
    """
    k = 1.0 if devkit_iou else 0.0

    def ignored(g: GroundTruth) -> bool:
        if g.difficult:
            return True
        return area_range is not None and not (
            area_range[0] <= _box_area(g.box, k) <= area_range[1])

    def det_out_of_band(d: Detection) -> bool:
        return area_range is not None and not (
            area_range[0] <= _box_area(d.box, k) <= area_range[1])

    npos = sum(1 for g in ground_truths if not ignored(g))
    if npos == 0:
        return 0.0
    gt_by_image: Dict[str, List[GroundTruth]] = {}
    for g in ground_truths:
        gt_by_image.setdefault(g.image_id, []).append(g)
    matched: Dict[str, np.ndarray] = {
        k_: np.zeros(len(v), bool) for k_, v in gt_by_image.items()}

    dets = sorted(detections, key=lambda d: -d.score)
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, d in enumerate(dets):
        gts = gt_by_image.get(d.image_id, [])
        if not gts:
            if not det_out_of_band(d):
                fp[i] = 1
            continue
        gt_boxes = np.array([g.box for g in gts], dtype=np.float64)
        ious = _iou_np(np.asarray(d.box, np.float64), gt_boxes,
                       inclusive=1.0 if devkit_iou else 0.0)
        # AREA-BAND mode only: prefer the best UNMATCHED non-ignored GT
        # above threshold; when none clears it fall back to the plain
        # argmax (an ignored pick drops the det, a matched pick is a
        # duplicate FP — unchanged semantics). Without this, a det whose
        # highest-IoU GT is out-of-band would leave an in-band GT that
        # also clears the threshold unmatched; pycocotools both prefers
        # non-ignored GTs and skips already-matched ones. The plain VOC
        # protocol (area_range=None) keeps the devkit's bare argmax.
        j = int(np.argmax(ious))
        if area_range is not None:
            live = np.array([not ignored(g) for g in gts])
            live &= ~matched[d.image_id]
            cand = np.where(live & (ious >= iou_thresh), ious, -1.0)
            if cand.max() >= 0:
                j = int(np.argmax(cand))
        if ious[j] >= iou_thresh:
            if ignored(gts[j]):
                continue  # ignore: neither tp nor fp
            if not matched[d.image_id][j]:
                matched[d.image_id][j] = True
                tp[i] = 1
            elif not det_out_of_band(d):
                fp[i] = 1  # duplicate detection of a matched GT
        elif not det_out_of_band(d):
            fp[i] = 1

    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / npos
    precision = ctp / np.maximum(ctp + cfp, np.finfo(np.float64).eps)
    return voc_ap(recall, precision, use_07_metric)


# COCO's primary-metric IoU ladder (0.50:0.05:0.95)
COCO_IOUS = tuple(round(0.50 + 0.05 * i, 2) for i in range(10))


def coco_map(detections_by_class: Dict[str, List[Detection]],
             gts_by_class: Dict[str, List[GroundTruth]],
             devkit_iou: bool = False) -> Tuple[float, Dict[str, float]]:
    """mAP@[.50:.95] — the COCO primary metric's IoU-averaged shape, on
    the VOC matching protocol (a localization-quality audit alongside the
    headline mAP@50, BASELINE.json:2).

    Per class: mean of the all-point AP over the 10 IoU thresholds
    0.50:0.05:0.95, then mean over classes with ground truth. Deltas from
    pycocotools' exact number, stated so results are comparable: AP here
    is the exact precision-envelope area (VOC post-2010) rather than
    COCO's 101-recall-point sampling of the same envelope (sub-0.1 AP
    difference), and VOC's ``difficult`` ignore-handling is kept (COCO has
    no difficult flag). Returns (mAP, per-class dict).
    """
    per_class: Dict[str, float] = {}
    for cls, gts in gts_by_class.items():
        if not any(not g.difficult for g in gts):
            continue
        dets = detections_by_class.get(cls, [])
        per_class[cls] = float(np.mean([
            class_ap(dets, gts, iou_thresh=t, use_07_metric=False,
                     devkit_iou=devkit_iou)
            for t in COCO_IOUS]))
    m = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return m, per_class


# COCO's object-size bands (areas in px²; box area stands in for COCO's
# segmentation area — stated so numbers are comparable). Band membership
# is lo <= area <= hi with INCLUSIVE bounds, mirroring pycocotools'
# aRng check exactly: a 32²/96² px² box belongs to both adjacent bands.
COCO_AREA_RANGES = {
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float("inf")),
}


def coco_map_by_area(
        detections_by_class: Dict[str, List[Detection]],
        gts_by_class: Dict[str, List[GroundTruth]],
        devkit_iou: bool = False) -> Dict[str, float]:
    """AP_small / AP_medium / AP_large — COCO's size-band diagnostics
    (pycocotools ``areaRng``), on the VOC matching protocol like
    :func:`coco_map`: per band, the all-point AP averaged over the
    0.50:0.05:0.95 IoU ladder and over classes. Classes with no
    in-band ground truth are skipped for that band (pycocotools' -1
    exclusion); a band with no ground truth at all maps to ``None``.
    Detector eval on small objects is the usual pruning casualty, so
    the bands localize WHERE compression hurt before the headline mAP
    moves.
    """
    k = 1.0 if devkit_iou else 0.0
    out: Dict[str, float] = {}
    for band, rng in COCO_AREA_RANGES.items():
        per_class = []
        for cls, gts in gts_by_class.items():
            if not any(not g.difficult
                       and rng[0] <= _box_area(g.box, k) <= rng[1]
                       for g in gts):
                continue
            dets = detections_by_class.get(cls, [])
            per_class.append(float(np.mean([
                class_ap(dets, gts, iou_thresh=t, use_07_metric=False,
                         devkit_iou=devkit_iou, area_range=rng)
                for t in COCO_IOUS])))
        out[band] = float(np.mean(per_class)) if per_class else None
    return out


def mean_ap(detections_by_class: Dict[str, List[Detection]],
            gts_by_class: Dict[str, List[GroundTruth]],
            iou_thresh: float = 0.5,
            use_07_metric: bool = True,
            devkit_iou: bool = False) -> Tuple[float, Dict[str, float]]:
    """mAP over classes present in the ground truth.

    Returns (mAP, per-class AP dict). Classes with no GT are skipped (VOC
    devkit convention).
    """
    aps = {}
    for cls, gts in gts_by_class.items():
        if not any(not g.difficult for g in gts):
            continue
        aps[cls] = class_ap(detections_by_class.get(cls, []), gts,
                            iou_thresh, use_07_metric,
                            devkit_iou=devkit_iou)
    m = float(np.mean(list(aps.values()))) if aps else 0.0
    return m, aps
