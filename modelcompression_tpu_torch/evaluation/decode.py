"""YOLO decode, port of ``modelcompression_tpu/evaluation/decode.py``:
the [region] head of YOLOv2 and the [yolo] heads of YOLOv3 / YOLOv4.

The raw map is NHWC (B, H, W, A*(5+C)), Darknet's channel order: anchor-
major, per anchor [tx, ty, tw, th, to, class logits...]. [region]:

    bx = (sigmoid(tx) + cx) / W      by = (sigmoid(ty) + cy) / H
    bw = pw * exp(tw) / W            bh = ph * exp(th) / H
    objectness = sigmoid(to)         class probs = softmax(logits)

[yolo]: anchors in network-input pixels (only the head's ``mask``
anchors), the YOLOv4 ``scale_x_y`` offset, sigmoid class probabilities:

    bx = (s * sigmoid(tx) - (s - 1) / 2 + cx) / W
    bw = pw * exp(tw) / net_w        class probs = sigmoid(logits)

Everything is fixed-shape; thresholding happens downstream by masking.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from modelcompression_tpu_torch.models.cfg import (
    NetworkSpec, RegionLayer, YoloLayer,
)


@functools.lru_cache(maxsize=32)
def _anchors_on(pairs: Tuple[Tuple[float, float], ...],
                device: torch.device) -> torch.Tensor:
    """(A, 2) anchor tensor, copied to the device once per anchor set (a
    per-batch copy from pageable host memory would make the host wait for
    the device). Callers must not write to it."""
    return torch.tensor(pairs, dtype=torch.float32, device=device)


def decode_region(raw: torch.Tensor, region: RegionLayer
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """raw (B, H, W, A*(5+C)) fp32 -> boxes (B, H*W*A, 4) center-format
    normalized to [0, 1], objectness (B, H*W*A), class probs
    (B, H*W*A, C)."""
    b, h, w, _ = raw.shape
    a, c = region.num, region.classes
    raw = raw.reshape(b, h, w, a, 5 + c)
    dev = raw.device
    cy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    anchors = _anchors_on(region.anchor_pairs, dev)          # (A, 2)
    bx = (torch.sigmoid(raw[..., 0]) + cx[None, :, :, None]) / w
    by = (torch.sigmoid(raw[..., 1]) + cy[None, :, :, None]) / h
    bw = anchors[:, 0] * torch.exp(raw[..., 2]) / w
    bh = anchors[:, 1] * torch.exp(raw[..., 3]) / h
    obj = torch.sigmoid(raw[..., 4])
    cls = torch.softmax(raw[..., 5:], dim=-1)
    n = h * w * a
    boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(b, n, 4)
    return boxes, obj.reshape(b, n), cls.reshape(b, n, c)


def decode_yolo(raw: torch.Tensor, layer: YoloLayer, net_h: int,
                net_w: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One [yolo] head's raw map (B, H, W, A*(5+C)) fp32, A = len(mask)
    -> boxes (B, H*W*A, 4) center-format normalized to [0, 1],
    objectness (B, H*W*A), class probs (B, H*W*A, C) (independent
    sigmoids, multi-label)."""
    b, h, w, _ = raw.shape
    a, c = layer.n, layer.classes
    raw = raw.reshape(b, h, w, a, 5 + c)
    dev = raw.device
    cy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    anchors = _anchors_on(layer.anchor_pairs, dev)           # (A, 2) px
    s = layer.scale_x_y
    off = (s - 1.0) * 0.5
    bx = (s * torch.sigmoid(raw[..., 0]) - off + cx[None, :, :, None]) / w
    by = (s * torch.sigmoid(raw[..., 1]) - off + cy[None, :, :, None]) / h
    bw = anchors[:, 0] * torch.exp(raw[..., 2]) / net_w
    bh = anchors[:, 1] * torch.exp(raw[..., 3]) / net_h
    obj = torch.sigmoid(raw[..., 4])
    cls = torch.sigmoid(raw[..., 5:])
    n = h * w * a
    boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(b, n, 4)
    return boxes, obj.reshape(b, n), cls.reshape(b, n, c)


def decode_heads(raws, spec: NetworkSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode ``forward``'s return value: one map for a [region] spec, a
    tuple of per-head maps for a [yolo] spec, whose candidates are
    concatenated along N in network order."""
    if not spec.is_multi_head:
        raw = raws[0] if isinstance(raws, (tuple, list)) else raws
        return decode_region(raw, spec.region)
    heads = [spec.layers[i] for i in spec.head_indices()]
    n_maps = len(raws) if isinstance(raws, (tuple, list)) else 1
    if not isinstance(raws, (tuple, list)) or n_maps != len(heads):
        raise ValueError(
            f"multi-head spec has {len(heads)} [yolo] layers but forward "
            f"returned {n_maps} maps")
    net_h, net_w = spec.net.height, spec.net.width
    parts = [decode_yolo(r, l, net_h, net_w) for r, l in zip(raws, heads)]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def center_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2), same units."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def corners_to_image(boxes_xyxy: torch.Tensor, img_w, img_h,
                     net_w: int, net_h: int,
                     letterboxed: bool) -> torch.Tensor:
    """Map normalized network-input corner boxes back to source-image
    pixels. With ``letterboxed`` undo the letterbox with the EXACT
    round/floor geometry of ``letterbox_host``/``letterbox_device``
    (content size round(img*r), integer floor-half pads); else undo a
    stretch. ``img_w``/``img_h`` may be scalars or (B,) tensors."""
    dev = boxes_xyxy.device
    img_w = torch.as_tensor(img_w, dtype=torch.float32, device=dev)
    img_h = torch.as_tensor(img_h, dtype=torch.float32, device=dev)
    while img_w.dim() < boxes_xyxy.dim() - 1:
        img_w = img_w[..., None]
        img_h = img_h[..., None]
    x = boxes_xyxy[..., 0::2] * net_w
    y = boxes_xyxy[..., 1::2] * net_h
    if letterboxed:
        r = torch.minimum(net_w / img_w, net_h / img_h)
        new_w = torch.round(img_w * r)   # half-even, as Python's round
        new_h = torch.round(img_h * r)
        pad_x = torch.floor((net_w - new_w) / 2)
        pad_y = torch.floor((net_h - new_h) / 2)
        x = (x - pad_x[..., None]) / r[..., None]
        y = (y - pad_y[..., None]) / r[..., None]
    else:
        x = x * img_w[..., None] / net_w
        y = y * img_h[..., None] / net_h
    x = torch.minimum(torch.clamp(x, min=0), img_w[..., None])
    y = torch.minimum(torch.clamp(y, min=0), img_h[..., None])
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)
