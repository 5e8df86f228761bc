"""Detector recall audit, port of
``modelcompression_tpu/evaluation/recall.py`` (Darknet's ``detector
recall``).

Protocol (Darknet examples/detector.c semantics):

* decode all anchors, keep boxes whose objectness clears ``conf_thresh``
  (class probabilities are never consulted: this audits localization);
* class-agnostic greedy NMS at ``nms_thresh``;
* proposals = surviving boxes per image;
* per ground-truth box: best continuous IoU over the proposals (darknet
  box_iou, not the devkit +1 convention; ``difficult`` boxes count like
  any other);
* correct when best IoU > ``recall_iou``; report proposals/img, mean
  best-IoU and recall.

Forward + decode + objectness NMS + the per-GT best-IoU reduction are one
step per batch; ground truth goes to the device as a padded (B, M, 4)
pixel-coordinate array and only the (B, M) best-IoU array and small
counters come back. The forward is the eval step's (``pipeline._network``),
so the fused input stage runs here where it runs in ``evaluate``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.data.voc import Sample
from modelcompression_tpu_torch.evaluation.decode import (
    center_to_corners, corners_to_image, decode_heads,
)
from modelcompression_tpu_torch.evaluation.nms import nms_topk, pairwise_iou
from modelcompression_tpu_torch.evaluation.pipeline import (
    EvalConfig, _network, _pad_batch, _prep_batch,
)
from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import (
    Params, fold_batchnorm, params_to,
)


def make_recall_step(spec: NetworkSpec, config: EvalConfig,
                     src_hw: Optional[Tuple[int, int]] = None):
    """fn(params, images_uint8, img_w (B,), img_h (B,),
    gt_boxes (B, M, 4) source pixels, gt_mask (B, M) bool) ->
      (best_iou (B, M), proposals (B,) int32, n_cand (B,) int32).

    ``n_cand`` counts objectness candidates above conf_thresh per image
    (candidates beyond ``max_detections`` cannot become proposals)."""
    raw_map = _network(spec, config, src_hw)
    net_h, net_w = spec.net.height, spec.net.width

    def step(params: Params, images, img_w, img_h, gt_boxes, gt_mask):
        with torch.inference_mode():
            boxes, obj, _cls = decode_heads(raw_map(params, images), spec)
            dev = boxes.device
            img_w, img_h, gt_boxes = (
                torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (img_w, img_h, gt_boxes))
            gt_mask = torch.as_tensor(gt_mask, dtype=torch.bool, device=dev)
            corners = center_to_corners(boxes)
            n_cand = (obj > config.conf_thresh).sum(dim=-1,
                                                     dtype=torch.int32)
            sel, _scores, valid = nms_topk(
                corners, obj, iou_thresh=config.nms_thresh,
                score_thresh=config.conf_thresh,
                max_out=config.max_detections)
            sel = corners_to_image(sel, img_w[:, None], img_h[:, None],
                                   net_w, net_h, config.letterbox)
            iou = pairwise_iou(sel, gt_boxes)                  # (B, K, M)
            iou = torch.where(valid[:, :, None], iou, torch.zeros_like(iou))
            best = torch.where(gt_mask, iou.amax(dim=1),
                               torch.zeros_like(gt_mask, dtype=iou.dtype))
            proposals = valid.sum(dim=-1, dtype=torch.int32)
            return best, proposals, n_cand

    return step


@dataclasses.dataclass
class RecallResult:
    n_images: int
    n_gt: int
    n_correct: int
    n_proposals: int
    iou_sum: float       # sum of per-GT best IoU (mean = iou_sum / n_gt)
    recall_iou: float
    images_per_sec: float = 0.0
    max_candidates: int = 0   # worst per-image objectness candidate count
    max_detections: int = 0

    @property
    def recall(self) -> float:
        return self.n_correct / self.n_gt if self.n_gt else 0.0

    @property
    def avg_iou(self) -> float:
        return self.iou_sum / self.n_gt if self.n_gt else 0.0

    @property
    def proposals_per_image(self) -> float:
        return self.n_proposals / self.n_images if self.n_images else 0.0

    def summary(self) -> str:
        lines = [
            f"recall@IoU>{self.recall_iou:g} (objectness-only, darknet "
            f"'detector recall' protocol): "
            f"{self.n_correct}/{self.n_gt} = {self.recall * 100:.2f}%",
            f"avg best-IoU per GT: {self.avg_iou * 100:.2f}%   "
            f"proposals/img: {self.proposals_per_image:.2f}   "
            f"[{self.n_images} images, "
            f"{self.images_per_sec:.1f} img/s pipeline wall]",
        ]
        if self.max_candidates > self.max_detections:
            lines.append(
                f"note: worst image had {self.max_candidates} objectness "
                f"candidates above threshold but NMS keeps top-"
                f"{self.max_detections} — raise --max-det (or --conf) if "
                f"proposals look truncated")
        return "\n".join(lines)


def evaluate_recall(params: Params, spec: NetworkSpec,
                    samples: Sequence[Sample], config: EvalConfig | None
                    = None, recall_iou: float = 0.5,
                    progress: bool = False) -> RecallResult:
    """Dataset recall audit (module docstring) on ``config.device``;
    ``params`` as for ``evaluate``."""
    config = config or EvalConfig()
    device = resolve_device(config.device)
    if config.fold_bn and config.forward_fn is None:
        params = fold_batchnorm(params, spec)
    params = params_to(params, device)
    step = make_recall_step(spec, config)
    net_h, net_w = spec.net.height, spec.net.width
    bs = config.batch_size

    # one GT pad width for the whole run
    m_pad = max((len(s.labels) for s in samples), default=1)
    m_pad = max(8, -(-m_pad // 8) * 8)

    res = RecallResult(0, 0, 0, 0, 0.0, recall_iou,
                       max_detections=config.max_detections)
    t0 = time.perf_counter()
    for start in range(0, len(samples), bs):
        chunk = list(samples[start:start + bs])
        batch, img_w, img_h = _pad_batch(
            *_prep_batch(chunk, net_h, net_w, config.letterbox), bs)
        gt = np.zeros((bs, m_pad, 4), np.float32)
        mask = np.zeros((bs, m_pad), bool)
        for bi, s in enumerate(chunk):
            w, h = float(img_w[bi]), float(img_h[bi])
            for gi, row in enumerate(s.labels[:m_pad]):
                _cls, cx, cy, bw, bh = row
                gt[bi, gi] = ((cx - bw / 2) * w, (cy - bh / 2) * h,
                              (cx + bw / 2) * w, (cy + bh / 2) * h)
                mask[bi, gi] = True
        best, proposals, n_cand = (t.cpu().numpy() for t in step(
            params, batch, img_w, img_h, gt, mask))
        nb = len(chunk)
        res.n_images += nb
        res.n_gt += int(mask[:nb].sum())
        res.n_correct += int((best[:nb][mask[:nb]] > recall_iou).sum())
        res.iou_sum += float(best[:nb][mask[:nb]].sum())
        res.n_proposals += int(proposals[:nb].sum())
        res.max_candidates = max(res.max_candidates,
                                 int(n_cand[:nb].max()) if nb else 0)
        if progress:  # darknet's cumulative per-batch line
            print(f"{res.n_images:5d}  {res.n_correct}/{res.n_gt}  "
                  f"RPs/Img: {res.proposals_per_image:.2f}  "
                  f"IoU: {res.avg_iou * 100:.2f}%  "
                  f"Recall: {res.recall * 100:.2f}%", flush=True)
    wall = time.perf_counter() - t0
    res.images_per_sec = res.n_images / wall if wall else 0.0
    return res
