"""Multi-head [yolo] loss (YOLOv3 / YOLOv4), port of
``modelcompression_tpu/train/yolo_loss.py``, and the family dispatch.

Public Darknet ``yolo_layer.c`` semantics, with the shared scatter
formulation of ``train/region_loss.py``:

* Every predictor whose best IoU against all GT is below ``ignore_thresh``
  gets a no-object loss ``KL(0 || sigmoid(to))``; predictors above it that
  are not assigned get no objectness loss (the ignore band).
* Each GT picks the best shape-only-IoU anchor among all ``num`` anchors of
  the shared pixel-unit list and is assigned only in the head whose
  ``mask`` holds that anchor, at the cell holding its center. With
  ``iou_thresh < 1`` (yolov4.cfg ships 0.213) it also trains every anchor
  slot whose shape IoU clears the threshold (Darknet's multi-anchor
  assignment): the (GT, slot) pairs are flattened into M*A scatter rows per
  head, GT-major, so the later-row-wins duplicate rule stays the
  reference's sequential overwrite.
* Assigned predictors get a coord loss, ``KL(1 || sigmoid(to))`` and a
  per-class sigmoid BCE against the one-hot row (multi-label).
  ``iou_loss = mse``: scale ``(2 - gw*gh)`` on KL-BCE for the logistic x/y
  logits (targets rescaled for ``scale_x_y``) and half squared error on
  the linear w/h. ``iou_loss = giou|diou|ciou``: ``iou_normalizer * (1 -
  XIoU)``, whose gradient follows Darknet's delta convention, a truncated
  chain rule (see ``yolo_loss``); ``max_delta`` clips the deltas after the
  normalizer.
* ``cls_normalizer`` scales the objectness terms (obj and noobj), not the
  class terms, as the yolov4-release Darknet does.

``truth_thresh < 1`` (multi-truth assignment, dead in every public cfg) is
rejected. Fixed shapes: targets arrive as (B, M, 5) with w == 0 rows
invalid; the assignment is a scatter with no host synchronisation.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.models.cfg import NetworkSpec, YoloLayer
from modelcompression_tpu_torch.train.region_loss import (
    RegionLossMetrics, _anchors_on, _bce_kl, _pair_iou, loss_metrics,
    region_loss,
)


@functools.lru_cache(maxsize=32)
def _index_on(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """An int64 tensor of ``values`` on ``device``, copied there once (as
    ``region_loss._anchors_on``). Callers must not write to it."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _iou_box_penalty(kind: str, px, py, pw, ph, tx, ty, tw, th):
    """Elementwise IoU-family box penalty ``1 - XIoU`` on center-format
    normalized boxes, with the published gradient conventions built in, so
    autograd of this function gives the Darknet / paper partials with
    respect to the decoded predicted box:

    * ``giou``: 1 - (IoU - (C - U)/C), C the enclosing box's area
      (Rezatofighi et al. 2019).
    * ``diou``: 1 - IoU + rho^2/c^2, the center distance over the
      enclosing box's squared diagonal (Zheng et al. 2020).
    * ``ciou``: DIoU + alpha*v, with the paper's two conventions: alpha is
      a constant in the backward, and d atan(pw/ph)/d{pw, ph} = {ph, -pw}
      (the true 1/(pw^2+ph^2) factor replaced by 1). Built as a detached
      surrogate whose value is the true atan.

    Every division is eps-guarded, so rows whose target is empty (masked
    out by the caller) stay finite in the forward and the backward.
    ``torch.maximum`` / ``torch.minimum`` split a tie's gradient as
    ``jnp.maximum`` does."""
    eps = 1e-9
    zero = px.new_zeros(())

    def floor_at(x, v):
        return torch.maximum(x, x.new_full((), v))

    pl, pr = px - pw * 0.5, px + pw * 0.5
    pt, pb = py - ph * 0.5, py + ph * 0.5
    tl, tr = tx - tw * 0.5, tx + tw * 0.5
    tt, tb = ty - th * 0.5, ty + th * 0.5
    iw = torch.maximum(torch.minimum(pr, tr) - torch.maximum(pl, tl), zero)
    ih = torch.maximum(torch.minimum(pb, tb) - torch.maximum(pt, tt), zero)
    inter = iw * ih
    union = pw * ph + tw * th - inter
    iou = inter / floor_at(union, eps)
    cw = torch.maximum(pr, tr) - torch.minimum(pl, tl)
    ch = torch.maximum(pb, tb) - torch.minimum(pt, tt)
    if kind == "giou":
        c_area = cw * ch
        return 1.0 - (iou - (c_area - union) / floor_at(c_area, eps))
    c2 = cw * cw + ch * ch
    s2 = (px - tx) ** 2 + (py - ty) ** 2
    dterm = s2 / floor_at(c2, eps)
    if kind == "diou":
        return 1.0 - iou + dterm
    if kind != "ciou":
        raise ValueError(f"unknown iou_loss kind {kind!r}")
    atan_p = torch.atan(pw / floor_at(ph, eps))
    # surrogate: value == atan_p, d/dpw == ph, d/dph == -pw; lin's value is
    # identically 0
    lin = pw * ph.detach() - ph * pw.detach()
    atan_p = atan_p.detach() + lin
    atan_t = torch.atan(tw / floor_at(th, eps))
    v = (4.0 / math.pi ** 2) * (atan_t - atan_p) ** 2
    alpha = (v / floor_at(1.0 - iou + v, eps)).detach()
    return 1.0 - iou + dterm + alpha * v


def _head_layers(spec: NetworkSpec) -> Tuple[YoloLayer, ...]:
    heads = tuple(spec.layers[i] for i in spec.head_indices())
    anchors0 = heads[0].anchors
    for h in heads:
        if not isinstance(h, YoloLayer):
            raise ValueError("yolo_loss needs [yolo] heads (use "
                             "region_loss for [region] specs)")
        if h.anchors != anchors0:
            raise ValueError(
                "[yolo] heads must share one anchor list (the mask= "
                "selects each scale's subset from it)")
        if h.truth_thresh < 1.0:
            raise ValueError(
                f"truth_thresh={h.truth_thresh} < 1 (multi-truth "
                "assignment) is not supported; every public yolov3 cfg "
                "uses truth_thresh=1")
    return heads


def yolo_loss(raws: Sequence[torch.Tensor], targets: torch.Tensor,
              spec: NetworkSpec, reduce=None) -> RegionLossMetrics:
    """The summed multi-head [yolo] loss.

    Args:
      raws: per-scale raw maps in network order (what ``forward`` returns
        for a multi-head spec), each (B, Hk, Wk, Ak*(5+C)); cast to
        float32 here (kept when wider).
      targets: (B, M, 5) rows [cls, cx, cy, w, h] normalized; w == 0 pads.
      spec: the network spec (head layers, net input size).
      reduce: data-parallel sum over the ranks (``region_loss.
        loss_metrics``).

    Returns RegionLossMetrics; ``loss`` is the scalar sum over heads over
    the batch size.
    """
    heads = _head_layers(spec)
    if len(raws) != len(heads):
        raise ValueError(f"spec has {len(heads)} [yolo] heads but got "
                         f"{len(raws)} raw maps")
    net_h, net_w = spec.net.height, spec.net.width
    b = raws[0].shape[0]
    dev = raws[0].device
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    if targets.shape[1] == 0:  # keep reductions on a non-empty axis
        targets = torch.zeros((b, 1, 5), dtype=torch.float32, device=dev)
    m = targets.shape[1]

    gt_valid = targets[..., 3] > 0  # (B, M)
    gt_boxes = targets[..., 1:5]
    gt_cls = targets[..., 0].to(torch.int64)

    # best anchor per GT over the whole shared anchor list (pixel units,
    # shape-only IoU at the origin): it decides which head assigns the GT
    h0 = heads[0]
    all_anchors = _anchors_on(tuple((h0.anchors[2 * k], h0.anchors[2 * k + 1])
                                    for k in range(h0.num)), dev)
    zeros = torch.zeros_like(gt_boxes[..., 2])
    gt_wh = torch.stack([zeros, zeros, gt_boxes[..., 2] * net_w,
                         gt_boxes[..., 3] * net_h], -1)  # (B, M, 4)
    anc_wh = torch.cat([torch.zeros_like(all_anchors), all_anchors], -1)
    shape_iou = _pair_iou(gt_wh[:, :, None, :], anc_wh[None, None, :, :])
    ga_global = torch.argmax(shape_iou, dim=-1)  # (B, M), first maximum

    acc = {k: 0.0 for k in ("coord", "obj", "noobj", "cls", "iou_sum",
                            "recall", "wins", "to_obj", "n_obj", "to_noobj",
                            "n_noobj")}

    for layer, raw in zip(heads, raws):
        _, h, w, _ = raw.shape
        a, c = layer.n, layer.classes
        raw = raw.reshape(b, h, w, a, 5 + c)
        raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
        anchors = _anchors_on(tuple(map(tuple, layer.anchor_pairs)), dev)

        tx = torch.sigmoid(raw[..., 0])
        ty = torch.sigmoid(raw[..., 1])
        tw = raw[..., 2]
        th = raw[..., 3]
        to = torch.sigmoid(raw[..., 4])

        cy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        cx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        # scale_x_y: the decode of evaluation/decode.decode_yolo, offset
        # s*sigmoid(t) - (s-1)/2
        s_xy = layer.scale_x_y
        off_xy = (s_xy - 1.0) * 0.5
        px = (s_xy * tx - off_xy + cx[None, :, :, None]) / w
        py = (s_xy * ty - off_xy + cy[None, :, :, None]) / h
        pw = anchors[:, 0] * torch.exp(tw) / net_w
        ph = anchors[:, 1] * torch.exp(th) / net_h
        pred_boxes = torch.stack([px, py, pw, ph], -1)  # (B,H,W,A,4)

        # ignore band: predictors overlapping any GT above ignore_thresh
        # get no objectness penalty even when unassigned
        with torch.no_grad():
            ious_all = _pair_iou(pred_boxes[:, :, :, :, None, :],
                                 gt_boxes[:, None, None, None, :, :])
            ious_all = torch.where(gt_valid[:, None, None, None, :],
                                   ious_all, 0.0)
            noobj_mask = ious_all.amax(dim=-1) < layer.ignore_thresh

        # per-slot eligibility (B, M, A): slot s holds the GT's best global
        # anchor, or (iou_thresh < 1) its own anchor clears the threshold
        slot_of = np.full((layer.num,), -1, np.int64)
        for s, g in enumerate(layer.mask):
            slot_of[g] = s
        slot_best = _index_on(tuple(slot_of.tolist()), dev)[ga_global]
        sl = torch.arange(a, device=dev)
        elig = gt_valid[:, :, None] & (slot_best[:, :, None] == sl)
        if layer.iou_thresh < 1.0:
            head_iou = shape_iou.index_select(
                -1, _index_on(tuple(layer.mask), dev))
            elig = elig | (gt_valid[:, :, None]
                           & (head_iou > layer.iou_thresh))

        # float -> int64 truncates toward zero, as the JAX astype(int32)
        gi1 = (gt_boxes[..., 0] * w).to(torch.int64).clamp(0, w - 1)
        gj1 = (gt_boxes[..., 1] * h).to(torch.int64).clamp(0, h - 1)

        # (GT, slot) pairs as m2 = M*A rows, GT-major: two rows of one GT
        # never collide (distinct anchors give distinct keys)
        m2 = m * a

        def rows(x):  # (B, M, ...) -> (B, M*A, ...), repeated per slot
            return torch.repeat_interleave(x, a, dim=1)

        ga2 = sl.repeat(b, m)                 # (B, M*A): row r -> r % a
        wins0 = elig.reshape(b, m2)
        gi = rows(gi1)
        gj = rows(gj1)
        gt_boxes2 = rows(gt_boxes)            # (B, M*A, 4)
        gt_cls2 = rows(gt_cls)
        batch_idx2 = torch.arange(b, device=dev)[:, None].expand(b, m2)

        # duplicate (cell, anchor) slots: the last valid row wins
        key = (gj * w + gi) * a + ga2
        ar = torch.arange(m2, device=dev)
        later = ar[None, :, None] < ar[None, None, :]
        dup_later = torch.any(
            later & wins0[:, None, :] & (key[:, :, None] == key[:, None, :]),
            dim=-1)
        wins = wins0 & ~dup_later
        # rows that do not win go to row h of a grid one row taller, which
        # is cut off: the JAX scatter's mode="drop" with fixed shapes and no
        # host sync. Winners' keys are unique, so only row h takes
        # duplicates.
        index = (batch_idx2, torch.where(wins, gj, h), gi, ga2)

        def scat(values):
            grid = torch.zeros((b, h + 1, w, a), dtype=torch.float32,
                               device=dev)
            grid.index_put_(index, values.detach().float())
            return grid[:, :h]

        assigned = scat(torch.ones_like(wins, dtype=torch.float32)) > 0
        t_cls = scat(gt_cls2.float()).to(torch.int64)
        amask = assigned.float()
        zx, zy, zo = raw[..., 0], raw[..., 1], raw[..., 4]
        eps = 1e-9

        if layer.iou_loss == "mse":
            t_x = scat(gt_boxes2[..., 0] * w - gi.float())
            t_y = scat(gt_boxes2[..., 1] * h - gj.float())
            t_w = scat(torch.log(torch.clamp_min(gt_boxes2[..., 2] * net_w,
                                                 eps) / anchors[ga2][..., 0]))
            t_h = scat(torch.log(torch.clamp_min(gt_boxes2[..., 3] * net_h,
                                                 eps) / anchors[ga2][..., 1]))
            coord_w = scat(2.0 - gt_boxes2[..., 2] * gt_boxes2[..., 3])
            # KL-BCE on the logistic logits, half squared error on tw/th.
            # scale_x_y: Darknet's delta on the logit is s*(t - (s*sig -
            # (s-1)/2)) = s^2 * ((t + (s-1)/2)/s - sig), the gradient of
            # s^2 * BCE against the rescaled target (t + (s-1)/2)/s
            t_x_s = (t_x + off_xy) / s_xy
            t_y_s = (t_y + off_xy) / s_xy
            acc["coord"] = acc["coord"] + torch.sum(coord_w * amask * (
                s_xy * s_xy * (_bce_kl(zx, t_x_s) + _bce_kl(zy, t_y_s))
                + 0.5 * ((tw - t_w) ** 2 + (th - t_h) ** 2)))
        else:
            # IoU-family loss: value iou_normalizer * sum(1 - XIoU) over
            # the assigned predictors; gradient Darknet's delta_yolo_box
            # convention: the penalty's partials in the decoded box land on
            # the raw outputs with a truncated chain rule (x/y straight
            # onto the logits, no sigmoid' or scale_x_y/grid factor; w/h
            # times exp(raw) only), clipped by max_delta after the
            # normalizer. The linear surrogate below has exactly that
            # gradient and contributes the true penalty's value.
            tbx, tby, tbw, tbh = (scat(gt_boxes2[..., k]) for k in range(4))
            iou_n = layer.iou_normalizer
            with torch.enable_grad():  # also under a caller's no_grad
                box = [t.detach().requires_grad_() for t in (px, py, pw, ph)]
                val = torch.sum(amask * _iou_box_penalty(
                    layer.iou_loss, *box, tbx, tby, tbw, tbh))
                gx, gy, gw, gh = torch.autograd.grad(val, box)
            deltas = [iou_n * gx, iou_n * gy,
                      iou_n * gw * torch.exp(tw.detach()),
                      iou_n * gh * torch.exp(th.detach())]
            if math.isfinite(layer.max_delta):
                deltas = [torch.clamp(t, -layer.max_delta, layer.max_delta)
                          for t in deltas]
            deltas = [(t * amask).detach() for t in deltas]
            lin = torch.sum(deltas[0] * zx + deltas[1] * zy
                            + deltas[2] * tw + deltas[3] * th)
            acc["coord"] = acc["coord"] + (iou_n * val.detach() + lin
                                           - lin.detach())

        # cls_normalizer scales the objectness terms, obj and noobj
        cn = layer.cls_normalizer
        acc["obj"] = acc["obj"] + cn * torch.sum(amask * F.softplus(-zo))
        acc["noobj"] = acc["noobj"] + cn * torch.sum(  # KL(0 || s(zo))
            torch.where(noobj_mask & ~assigned, F.softplus(zo), 0.0))
        onehot = F.one_hot(t_cls, c).float()
        acc["cls"] = acc["cls"] + torch.sum(
            amask[..., None] * _bce_kl(raw[..., 5:], onehot))

        # metrics over the winning (GT, slot) rows: with iou_thresh < 1
        # they include the extra multi-anchor positives
        with torch.no_grad():
            pred_at_gt = pred_boxes[batch_idx2, gj, gi, ga2]
            iou_at_gt = _pair_iou(pred_at_gt, gt_boxes2)
            vw = wins.float()
            acc["iou_sum"] += torch.sum(iou_at_gt * vw)
            acc["recall"] += torch.sum((iou_at_gt > 0.5) * vw)
            acc["wins"] += torch.sum(vw)
            acc["to_obj"] += torch.sum(to * amask)
            acc["n_obj"] += torch.sum(amask)
            acc["to_noobj"] += torch.sum(to * (1 - amask))
            acc["n_noobj"] += torch.sum(1 - amask)

    total = (acc["coord"] + acc["obj"] + acc["noobj"] + acc["cls"]) / b
    ratios = ((acc["iou_sum"], acc["wins"]), (acc["recall"], acc["wins"]),
              (acc["to_obj"], acc["n_obj"]), (acc["to_noobj"],
                                              acc["n_noobj"]))
    return loss_metrics(total, tuple(acc[k] for k in ("coord", "obj",
                                                      "noobj", "cls")),
                        b, ratios, torch.sum(gt_valid.float()), reduce)


def detection_loss(raw, targets: torch.Tensor, spec: NetworkSpec,
                   seen, reduce=None) -> RegionLossMetrics:
    """Family dispatch: [region] specs -> ``region_loss`` on the single raw
    map; [yolo] specs -> ``yolo_loss`` over the tuple of per-scale maps.
    ``seen`` gates [region]'s early prior loss; [yolo] has none.
    ``reduce``: data-parallel sum over the ranks
    (``region_loss.loss_metrics``)."""
    if spec.is_multi_head:
        return yolo_loss(raw, targets, spec, reduce=reduce)
    return region_loss(raw, targets, spec.region, seen, reduce=reduce)
