"""YOLOv2 region loss, port of ``modelcompression_tpu/train/region_loss.py``.

Public YOLOv2 semantics, configured by the [region] cfg section:

* Every anchor box whose best IoU against all GT is below ``thresh`` gets a
  no-object loss ``noobject_scale * KL(0 || sigmoid(to))``; anchors above
  ``thresh`` that are not assigned to a GT get no objectness loss.
* Early training (seen < 12800 images): every unassigned anchor gets a weak
  prior loss (scale 0.01) pulling its box to the anchor's shape.
* Each GT is assigned to the cell holding its center and the anchor with
  the best shape-only IoU: against the anchor priors when ``bias_match=1``,
  against the predicted w/h at that cell when ``bias_match=0`` (Darknet
  region_layer.c). Assigned anchors get a coord loss (KL-BCE on the
  logistic x/y logits, half squared error on the linear w/h, scale
  ``coord_scale * (2 - gw*gh)``), an objectness loss against the IoU
  (``rescore``, the IoU a constant target) or 1, and a class loss (softmax
  cross-entropy, or half squared error on the raw outputs with
  ``softmax=0``).

Every term is the antiderivative of Darknet's actual update (``delta =
scale * (target - output)`` with no logistic derivative), see ``_bce_kl``.

Fixed shapes as in the JAX package: targets arrive as a padded (B, M, 5)
tensor (rows with w == 0 are invalid) and the assignment is a scatter with
no host synchronisation. When two valid GTs land on the same (cell, anchor)
the later row wins, as the reference's sequential overwrite does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.models.cfg import RegionLayer

PRIOR_SEEN_CUTOFF = 12800
PRIOR_SCALE = 0.01


def _bce_kl(z: torch.Tensor, t) -> torch.Tensor:
    """KL(t || sigmoid(z)): the binary cross-entropy minus the target's own
    entropy. Its gradient in z is ``sigmoid(z) - t``, Darknet's delta for a
    logistic output (no sigmoid' factor, which would vanish at saturated
    logits); the subtracted entropy is constant in z, so the value is 0 at
    the optimum even for soft targets. ``t`` is a tensor or a Python
    float (then no tensor is made for it, so nothing is copied to the
    device)."""
    bce = F.softplus(z) - z * t
    if isinstance(t, torch.Tensor):
        ent = -(torch.special.xlogy(t, t)
                + torch.special.xlogy(1.0 - t, 1.0 - t))
    else:
        ent = -sum(v * math.log(v) for v in (t, 1.0 - t) if v > 0)
    return bce - ent


@functools.lru_cache(maxsize=16)
def _anchors_on(pairs: Tuple[Tuple[float, float], ...],
                device: torch.device) -> torch.Tensor:
    """(A, 2) float32 anchors on ``device``, copied there once: a copy from
    host memory in every step would make the host wait for the device.
    Callers must not write to it."""
    return torch.tensor(pairs, dtype=torch.float32, device=device)


def _pair_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., 4) center-format boxes (broadcasting)."""
    ax1 = boxes_a[..., 0] - boxes_a[..., 2] / 2
    ay1 = boxes_a[..., 1] - boxes_a[..., 3] / 2
    ax2 = boxes_a[..., 0] + boxes_a[..., 2] / 2
    ay2 = boxes_a[..., 1] + boxes_a[..., 3] / 2
    bx1 = boxes_b[..., 0] - boxes_b[..., 2] / 2
    by1 = boxes_b[..., 1] - boxes_b[..., 3] / 2
    bx2 = boxes_b[..., 0] + boxes_b[..., 2] / 2
    by2 = boxes_b[..., 1] + boxes_b[..., 3] / 2
    ix = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0)
    iy = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0)
    inter = ix * iy
    union = ((ax2 - ax1).clamp_min(0) * (ay2 - ay1).clamp_min(0)
             + (bx2 - bx1).clamp_min(0) * (by2 - by1).clamp_min(0) - inter)
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       0.0)


@dataclasses.dataclass
class RegionLossMetrics:
    loss: torch.Tensor
    loss_coord: torch.Tensor
    loss_obj: torch.Tensor
    loss_noobj: torch.Tensor
    loss_cls: torch.Tensor
    avg_iou: torch.Tensor
    recall50: torch.Tensor
    obj_conf: torch.Tensor
    noobj_conf: torch.Tensor
    n_gt: torch.Tensor

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def loss_metrics(total: torch.Tensor, terms, b: int, ratios, n_gt,
                 reduce=None) -> RegionLossMetrics:
    """A detection loss's metrics from its batch sums.

    ``total`` is the differentiable loss, ``sum(terms) / b``; ``terms``
    the batch sums of the coord, obj, noobj and cls losses, then any
    other that ``total`` holds; ``ratios`` the (numerator, count) pairs of
    avg_iou, recall50, obj_conf and noobj_conf, each count clamped at 1;
    ``n_gt`` the valid ground-truth count.

    ``reduce`` (data parallel, from the train step) sums a 1-D tensor over
    the ranks. The sums, counts and ``b`` are reduced before the
    divisions, so every metric is the global batch's, ``loss`` included;
    ``loss`` keeps the gradient of this rank's ``total``, which the step
    averages over the ranks."""
    if reduce is None:
        with torch.no_grad():
            return RegionLossMetrics(
                total, *(t / b for t in terms[:4]),
                *(num / torch.clamp_min(cnt, 1.0) for num, cnt in ratios),
                n_gt=n_gt)
    with torch.no_grad():
        # b as a device fill: a host scalar would be copied from pageable
        # memory, which waits for the device
        flat = [*terms, total.new_full((), float(b)),
                *(x for pair in ratios for x in pair), n_gt]
        g = reduce(torch.stack([x.to(total.dtype) for x in flat]))
        k = len(terms)
        g_terms, g_b, g_ratios = g[:k], g[k], g[k + 1:k + 9]
        g_total = g_terms[0]
        for t in g_terms[1:]:
            g_total = g_total + t
        g_total = g_total / g_b
    metrics = RegionLossMetrics(
        total + (g_total - total).detach(), *(t / g_b for t in g_terms[:4]),
        *(g_ratios[i] / torch.clamp_min(g_ratios[i + 1], 1.0)
          for i in range(0, 8, 2)),
        n_gt=g[k + 9].to(n_gt.dtype))
    return metrics


def region_loss(raw: torch.Tensor, targets: torch.Tensor,
                region: RegionLayer, seen,
                reduce=None) -> RegionLossMetrics:
    """Compute the region loss.

    Args:
      raw: (B, H, W, A*(5+C)) network output (cast to float32 here, or
        kept when wider).
      targets: (B, M, 5) rows [cls, cx, cy, w, h] normalized; w==0 invalid.
      region: [region] config.
      seen: images seen so far (int or 0-dim tensor; the prior-loss gate).
      reduce: data-parallel sum over the ranks (``loss_metrics``).

    Returns RegionLossMetrics; ``loss`` is the scalar sum / batch.
    """
    b, h, w, _ = raw.shape
    a, c = region.num, region.classes
    dev = raw.device
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    if targets.shape[1] == 0:  # no GT slots: one invalid row keeps every
        # reduction below on a non-empty axis
        targets = torch.zeros((b, 1, 5), dtype=torch.float32, device=dev)
    m = targets.shape[1]
    raw = raw.reshape(b, h, w, a, 5 + c)
    raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
    anchors = _anchors_on(tuple(map(tuple, region.anchor_pairs)), dev)

    tx = torch.sigmoid(raw[..., 0])
    ty = torch.sigmoid(raw[..., 1])
    tw = raw[..., 2]
    th = raw[..., 3]
    to = torch.sigmoid(raw[..., 4])
    cls_logits = raw[..., 5:]

    # decoded predicted boxes (normalized) for the IoUs
    cy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    px = (tx + cx[None, :, :, None]) / w
    py = (ty + cy[None, :, :, None]) / h
    pw = anchors[:, 0] * torch.exp(tw) / w
    ph = anchors[:, 1] * torch.exp(th) / h
    pred_boxes = torch.stack([px, py, pw, ph], -1)  # (B,H,W,A,4)

    gt_valid = targets[..., 3] > 0  # (B, M)
    gt_boxes = targets[..., 1:5]    # (B, M, 4) cx cy w h
    gt_cls = targets[..., 0].to(torch.int64)

    # ---- background mask: best IoU of each anchor against all GT --------
    with torch.no_grad():
        ious_all = _pair_iou(pred_boxes[:, :, :, :, None, :],
                             gt_boxes[:, None, None, None, :, :])
        ious_all = torch.where(gt_valid[:, None, None, None, :], ious_all, 0.0)
        best_iou = ious_all.amax(dim=-1)  # (B,H,W,A)
        noobj_mask = best_iou < region.thresh

    # ---- GT assignment (scatter) ------------------------------------------
    # float -> int64 truncates toward zero, as the JAX astype(int32)
    gi = (gt_boxes[..., 0] * w).to(torch.int64).clamp(0, w - 1)
    gj = (gt_boxes[..., 1] * h).to(torch.int64).clamp(0, h - 1)
    batch_idx = torch.arange(b, device=dev)[:, None].expand(b, m)
    # best anchor by shape-only IoU (boxes at the origin): against the
    # priors with bias_match=1, else against the predicted w/h of each
    # anchor at the GT's cell (a constant: no gradient)
    zeros = torch.zeros_like(gt_boxes[..., 2])
    gt_wh = torch.stack([zeros, zeros, gt_boxes[..., 2] * w,
                         gt_boxes[..., 3] * h], -1)
    if region.bias_match:
        anc_wh = torch.cat([torch.zeros_like(anchors), anchors], -1)
        shape_iou = _pair_iou(gt_wh[:, :, None, :], anc_wh[None, None, :, :])
    else:
        pred_wh = pred_boxes[batch_idx, gj, gi][..., 2:4].detach()
        pw_c, ph_c = pred_wh[..., 0] * w, pred_wh[..., 1] * h  # cell units
        zeros_a = torch.zeros_like(pw_c)
        pred_sh = torch.stack([zeros_a, zeros_a, pw_c, ph_c], -1)
        shape_iou = _pair_iou(gt_wh[:, :, None, :], pred_sh)
    ga = torch.argmax(shape_iou, dim=-1)  # (B, M), first maximum on a tie

    vw = gt_valid.float()
    # duplicates: when two valid GTs map to the same (cell, anchor) only the
    # LAST row scatters (the reference's sequential overwrite)
    key = (gj * w + gi) * a + ga  # (B, M)
    ar = torch.arange(m, device=dev)
    later = ar[None, :, None] < ar[None, None, :]
    dup_later = torch.any(
        later & gt_valid[:, None, :] & (key[:, :, None] == key[:, None, :]),
        dim=-1)
    wins = gt_valid & ~dup_later
    # rows that do not win go to row h of a grid one row taller, which is
    # cut off: the JAX scatter's mode="drop" without a host-side filter
    gj_s = torch.where(wins, gj, h)
    index = (batch_idx, gj_s, gi, ga)

    def scat(values):
        grid = torch.zeros((b, h + 1, w, a), dtype=torch.float32, device=dev)
        grid.index_put_(index, values.detach().float())
        return grid[:, :h]

    assigned = scat(torch.ones_like(vw)) > 0

    t_x = scat(gt_boxes[..., 0] * w - gi.float())
    t_y = scat(gt_boxes[..., 1] * h - gj.float())
    eps = 1e-9
    t_w = scat(torch.log(torch.clamp_min(gt_boxes[..., 2] * w, eps)
                         / anchors[ga][..., 0]))
    t_h = scat(torch.log(torch.clamp_min(gt_boxes[..., 3] * h, eps)
                         / anchors[ga][..., 1]))
    coord_w = scat(region.coord_scale
                   * (2.0 - gt_boxes[..., 2] * gt_boxes[..., 3]))
    t_cls = scat(gt_cls.float()).to(torch.int64)

    # IoU of the assigned predictor with its GT (rescore target + metrics):
    # a constant, as in Darknet (delta = iou - sigmoid(to))
    pred_at_gt = pred_boxes[batch_idx, gj, gi, ga]  # (B, M, 4)
    iou_at_gt = _pair_iou(pred_at_gt, gt_boxes).detach()
    t_iou = scat(iou_at_gt)

    # ---- losses ------------------------------------------------------------
    amask = assigned.float()
    zx, zy, zo = raw[..., 0], raw[..., 1], raw[..., 4]
    loss_coord = torch.sum(coord_w * amask * (
        _bce_kl(zx, t_x) + _bce_kl(zy, t_y)
        + 0.5 * ((tw - t_w) ** 2 + (th - t_h) ** 2)))

    obj_target = t_iou if region.rescore else amask
    loss_obj = region.object_scale * torch.sum(amask * _bce_kl(zo, obj_target))
    # background target 0: KL(0 || sigmoid(z)) == softplus(z)
    loss_noobj = region.noobject_scale * torch.sum(
        torch.where(noobj_mask & ~assigned, F.softplus(zo), 0.0))

    if region.softmax:
        log_probs = F.log_softmax(cls_logits, dim=-1)
        ce = -torch.gather(log_probs, -1, t_cls[..., None])[..., 0]
        loss_cls = region.class_scale * torch.sum(amask * ce)
    else:
        # softmax=0: delta scale*(onehot - out) on the raw class outputs
        onehot = F.one_hot(t_cls, c).float()
        loss_cls = region.class_scale * 0.5 * torch.sum(
            amask[..., None] * (onehot - cls_logits) ** 2)

    prior_on = float(int(seen) < PRIOR_SEEN_CUTOFF)
    loss_prior = prior_on * PRIOR_SCALE * torch.sum(
        (1 - amask) * (_bce_kl(zx, 0.5) + _bce_kl(zy, 0.5)
                       + 0.5 * (tw ** 2 + th ** 2)))

    total = (loss_coord + loss_obj + loss_noobj + loss_cls + loss_prior) / b

    with torch.no_grad():
        n_gt = torch.sum(vw)
        ratios = ((torch.sum(iou_at_gt * vw), n_gt),
                  (torch.sum((iou_at_gt > 0.5) * vw), n_gt),
                  (torch.sum(to * amask), torch.sum(amask)),
                  (torch.sum(to * (1 - amask)), torch.sum(1 - amask)))
    return loss_metrics(total, (loss_coord, loss_obj, loss_noobj, loss_cls,
                                loss_prior), b, ratios, n_gt, reduce)
