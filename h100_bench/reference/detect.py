"""The serving path's plain reference and the comparison that decides
``correct`` for a served batch (``compare``: served detections against
what the reference's NMS may serve, both ways, within the strays that
rounding may cause: ``bands``).

Letterbox: aspect-preserving bilinear resize (half-pixel centers, edge
clamp, no antialias: the cv2 INTER_LINEAR / Darknet rule) to the network
size, centred, padded with 127/255. Decode: [region] (sigmoid offsets,
anchors in grid cells, exp sizes, sigmoid objectness, softmax classes)
and [yolo] (``scale_x_y`` offsets, anchors in input pixels, sigmoid
classes). Scores are objectness x class probability. NMS as served: a
class-agnostic top-``prefilter`` cut on each candidate's best score above
``conf``, then per class the top ``max_det`` above ``conf``, greedy IoU
suppression over ``nms`` among them. Boxes go back to source pixels
through the letterbox's geometry and are clipped to the image.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

GRAY = 127


def _resize_matrix(src: int, dst: int, device) -> torch.Tensor:
    i = torch.arange(dst, dtype=torch.float64)
    x = (i + 0.5) * (src / dst) - 0.5
    x0 = torch.floor(x)
    f = (x - x0).float()
    lo = x0.long().clamp(0, src - 1)
    hi = (x0.long() + 1).clamp(0, src - 1)
    m = torch.zeros(dst, src)
    m.index_put_((torch.arange(dst), lo), 1.0 - f, accumulate=True)
    m.index_put_((torch.arange(dst), hi), f, accumulate=True)
    return m.to(device)


def letterbox_geometry(src_h: int, src_w: int, net_h: int, net_w: int):
    r = min(net_w / src_w, net_h / src_h)
    new_w, new_h = int(round(src_w * r)), int(round(src_h * r))
    return r, new_w, new_h, (net_w - new_w) // 2, (net_h - new_h) // 2


def letterbox(frames_u8: torch.Tensor, net_h: int, net_w: int
              ) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, net_h, net_w) float32 in [0, 1]."""
    b, h, w, _ = frames_u8.shape
    _, new_w, new_h, pad_x, pad_y = letterbox_geometry(h, w, net_h, net_w)
    x = frames_u8.float().permute(0, 3, 1, 2) / 255.0
    x = _resize_matrix(h, new_h, x.device) @ x \
        @ _resize_matrix(w, new_w, x.device).t()
    out = torch.full((b, 3, net_h, net_w), GRAY / 255.0, device=x.device)
    out[:, :, pad_y:pad_y + new_h, pad_x:pad_x + new_w] = x
    return out


def decode(heads: List[torch.Tensor], head_layers: List[dict],
           net_h: int, net_w: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head inputs (NCHW) -> (B, N, 4) corner boxes normalized to the
    network input, (B, N, C) class scores; candidates in (head, row,
    column, anchor) order."""
    all_boxes, all_scores = [], []
    for raw, l in zip(heads, head_layers):
        b, _, gh, gw = raw.shape
        anchors = torch.tensor(l["anchors"], device=raw.device)
        a, c = anchors.shape[0], l["classes"]
        t = raw.float().permute(0, 2, 3, 1).reshape(b, gh, gw, a, 5 + c)
        cy = torch.arange(gh, device=raw.device).float()[None, :, None,
                                                         None]
        cx = torch.arange(gw, device=raw.device).float()[None, None, :,
                                                         None]
        if l["type"] == "region":
            bx = (torch.sigmoid(t[..., 0]) + cx) / gw
            by = (torch.sigmoid(t[..., 1]) + cy) / gh
            bw = anchors[:, 0] * torch.exp(t[..., 2]) / gw
            bh = anchors[:, 1] * torch.exp(t[..., 3]) / gh
            cls = torch.softmax(t[..., 5:], dim=-1)
        else:
            s = l["scale_x_y"]
            bx = (s * torch.sigmoid(t[..., 0]) - (s - 1) / 2 + cx) / gw
            by = (s * torch.sigmoid(t[..., 1]) - (s - 1) / 2 + cy) / gh
            bw = anchors[:, 0] * torch.exp(t[..., 2]) / net_w
            bh = anchors[:, 1] * torch.exp(t[..., 3]) / net_h
            cls = torch.sigmoid(t[..., 5:])
        obj = torch.sigmoid(t[..., 4])
        boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2,
                             by + bh / 2], dim=-1)
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_scores.append((obj[..., None] * cls).reshape(b, -1, c))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


def to_pixels(boxes: torch.Tensor, src_h: int, src_w: int, net_h: int,
              net_w: int) -> torch.Tensor:
    r, _, _, pad_x, pad_y = letterbox_geometry(src_h, src_w, net_h, net_w)
    x = ((boxes[..., 0::2] * net_w - pad_x) / r).clamp(0, src_w)
    y = ((boxes[..., 1::2] * net_h - pad_y) / r).clamp(0, src_h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def _top(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda t: (t[..., 2:] - t[..., :2]).clamp_min(0).prod(-1)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(boxes: torch.Tensor, scores: torch.Tensor, conf: float,
        iou: float, max_det: int, prefilter: int):
    """(B, N, 4), (B, N, C) -> boxes (B, C, K, 4) normalized, scores
    (B, C, K), valid (B, C, K)."""
    if prefilter:
        m = scores.amax(dim=-1)
        m = torch.where(m > conf, m, torch.zeros_like(m))
        mv, idx = _top(m, min(prefilter, m.shape[1]))
        boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        scores = torch.gather(scores, 1, idx[..., None].expand(
            -1, -1, scores.shape[-1]))
        scores = torch.where(mv[..., None] > 0, scores,
                             torch.zeros_like(scores))
    s = scores.transpose(1, 2)                               # (B, C, N')
    s = torch.where(s > conf, s, torch.zeros_like(s))
    k = min(max_det, s.shape[-1])
    vals, idx = _top(s, k)
    cand = torch.gather(boxes[:, None].expand(-1, s.shape[1], -1, -1), 2,
                        idx[..., None].expand(-1, -1, -1, 4))
    sup = _iou(cand, cand) > iou
    live = vals > 0
    keep = []
    for i in range(k):
        keep.append(live[..., i])
        later = torch.arange(k, device=s.device) > i
        live = live & ~(sup[..., i, :] & later & live[..., i:i + 1])
    valid = torch.stack(keep, -1) & (vals > 0)
    return cand, torch.where(valid, vals, torch.zeros_like(vals)), valid


def serve(folded, net, layers, frames_u8, serving: Dict, lowp=None,
          chunk: int = 16) -> Dict[str, object]:
    """The whole served path on a batch of source frames (B, H, W, 3)
    uint8, in chunks of ``chunk`` images. Returns ``norm``: the candidate
    corner boxes normalized to the network input (B, N, 4); ``boxes``:
    the same in source pixels, clipped (B, N, 4); ``side``: each
    candidate's longer side in source pixels before clipping (B, N);
    ``scores``: the candidates' class scores (B, N, C); ``det``: the
    served detections, (pixel boxes (B, C, K, 4), scores (B, C, K),
    valid (B, C, K))."""
    from h100_bench.reference.model import forward
    heads = [l for l in layers if l["type"] in ("yolo", "region")]
    net_h, net_w = int(net["height"]), int(net["width"])
    src_hw = tuple(frames_u8.shape[1:3])
    r = letterbox_geometry(*src_hw, net_h, net_w)[0]
    outs = []
    for lo in range(0, frames_u8.shape[0], chunk):
        x = letterbox(frames_u8[lo:lo + chunk], net_h, net_w)
        raw = forward(folded, layers, x, lowp=lowp)
        boxes, scores = decode(raw, heads, net_h, net_w)
        db, ds, dv = nms(boxes, scores, serving["conf"], serving["nms"],
                         serving["max_detections"], serving["nms_prefilter"])
        side = torch.maximum((boxes[..., 2] - boxes[..., 0]) * net_w,
                             (boxes[..., 3] - boxes[..., 1]) * net_h) / r
        outs.append((boxes, to_pixels(boxes, *src_hw, net_h, net_w), side,
                     scores, to_pixels(db, *src_hw, net_h, net_w), ds, dv))
    norm, boxes, side, scores, db, ds, dv = (torch.cat(p)
                                             for p in zip(*outs))
    return {"norm": norm, "boxes": boxes, "side": side, "scores": scores,
            "det": (db, ds, dv)}


def _count_ge(asc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Entries of each ascending row of ``asc`` that are >= ``x``."""
    return asc.shape[-1] - torch.searchsorted(asc, x.contiguous())


def _count_gt(asc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return asc.shape[-1] - torch.searchsorted(asc, x.contiguous(),
                                              right=True)


def bands(norm: torch.Tensor, scores: torch.Tensor, serving: Dict,
          band: Dict[str, float]):
    """Which of the reference's candidates reach a class's top
    ``max_det`` (the set that NMS then suppresses among) when a served
    path's scores stray from the reference's by rounding.

    Two scores within a factor ``rho = 1 + band["score"]`` of each other
    may come out in either order, and a score within that factor of
    ``conf`` on either side of it. Through the class-agnostic
    top-``prefilter`` cut on the best score and the class's top
    ``max_det`` a candidate is *possible* where fewer than the cut's
    count of others surely outrank it, and *sure* where fewer than that
    may outrank it.

    norm (B, N, 4), scores (B, N, C) -> (idx, possible, sure), each
    (B, C, Q): per image and class the Q best candidates that may reach
    the top ``max_det`` (Q the most over images and classes), by score,
    and whether each is possible and sure.
    """
    rho, conf = 1.0 + band["score"], serving["conf"]
    n = scores.shape[1]
    k = min(serving["max_detections"], n)
    neg = torch.full((), -math.inf, device=scores.device)
    m = scores.amax(dim=-1)                                  # (B, N)
    if serving["nms_prefilter"]:
        p = min(serving["nms_prefilter"], n)
        asc = torch.sort(m, dim=-1).values
        sure_pf = (m > conf * rho) & (_count_ge(asc, m / rho) - 1 < p)
        poss_pf = (m > conf / rho) & (
            _count_gt(asc, m.clamp_min(conf) * rho) < p)
    else:
        sure_pf = poss_pf = torch.ones_like(m, dtype=torch.bool)
    s = scores.transpose(1, 2).contiguous()                  # (B, C, N)
    asc_p = torch.sort(torch.where(poss_pf[:, None], s, neg), -1).values
    asc_s = torch.sort(torch.where(sure_pf[:, None], s, neg), -1).values
    sure = sure_pf[:, None] & (s > conf * rho) & (
        _count_ge(asc_p, s / rho) - 1 < k)
    possible = poss_pf[:, None] & (s > conf / rho) & (
        _count_gt(asc_s, s.clamp_min(conf) * rho) < k)
    q = max(1, int(possible.sum(dim=-1).max()))
    _, idx = _top(torch.where(possible, s, neg), q)
    return (idx, torch.gather(possible, -1, idx),
            torch.gather(sure, -1, idx))


def compare(port, ref: Dict[str, object], serving: Dict,
            band: Dict[str, float]) -> Dict[str, float]:
    """How far the served detections lie from what the reference's NMS
    may serve, read three ways; ``det_gap`` is the largest.

    ``port``: (boxes (B, C, K, 4) in source pixels, scores (B, C, K),
    valid (B, C, K)); ``ref``: ``serve``'s output; ``band``: the strays
    of scores and IoUs that rounding may cause (``bands``; an IoU within
    ``band["iou"]`` of the NMS threshold may fall on either side).

    The gap between a served detection and a reference candidate of its
    image and class is the larger of the corner gap over the candidate's
    longer side before clipping (+1 px: a box that runs off the image
    carries the error of its whole extent) and the score gap over the
    candidate's score (at least ``conf``), read as 1 at most (nothing
    within a box's side). Each served detection stands for its nearest
    candidate among those that may reach the class's top ``max_det``.

    ``served``: over every served detection, that gap: a wrong box or
    score, or one the reference surely cuts. ``overlap``: over every two
    served detections of a class, how far their candidates' IoU exceeds
    the threshold plus the band, over what lies above that: greedy NMS
    never keeps both. Clipping at the frame makes some candidates' served
    boxes all but equal, so a served detection may stand for any
    candidate within ``band["match"]`` of its nearest; a pair counts with
    the least IoU between the candidates each may stand for, and only
    where each may stand for at most eight. ``held``: over every
    candidate surely in the class's top ``max_det``, which NMS either
    keeps or suppresses under a kept one, 0 where a served detection may
    stand for it or for a candidate that may outrank it and overlaps it
    past the threshold less the band, else the gap to the nearest served
    detection: one the port left out.
    """
    conf, thr = serving["conf"], serving["nms"]
    rho, eps = 1.0 + band["score"], band["iou"]
    idx, possible, sure = bands(ref["norm"], ref["scores"], serving, band)
    c = idx.shape[1]
    dev = idx.device

    def pool(t, width):
        return torch.gather(t[:, None].expand(-1, c, -1, -1), 2,
                            idx[..., None].expand(-1, -1, -1, width))

    rb, rn = pool(ref["boxes"], 4), pool(ref["norm"], 4)    # (B, C, Q, 4)
    side = pool(ref["side"][..., None], 1)[..., 0] + 1.0    # (B, C, Q)
    rs = torch.gather(ref["scores"].transpose(1, 2), 2, idx)
    pb, ps, pv = (torch.as_tensor(a).to(dev) for a in port)
    pb, ps, pv = pb.float(), ps.float(), pv.bool()
    far = torch.ones((), device=dev)
    worst = {k: torch.zeros((), device=dev)
             for k in ("served", "overlap", "held")}
    for lo in range(0, pb.shape[0], 8):
        sl = slice(lo, lo + 8)
        d_box = (pb[sl, :, :, None] - rb[sl, :, None]).abs().amax(-1) \
            / side[sl, :, None]                              # (b, C, K, Q)
        d_s = (ps[sl, ..., None] - rs[sl, :, None]).abs() \
            / rs[sl, :, None].clamp_min(conf)
        gap = torch.where(possible[sl, :, None],
                          torch.maximum(d_box, d_s).clamp_max(1.0), far)
        v = pv[sl]
        nearest = gap.amin(-1, keepdim=True)                 # (b, C, K, 1)
        worst["served"] = torch.maximum(worst["served"], torch.where(
            v, nearest[..., 0], 0.0).amax())
        may = v[..., None] & (gap < 1.0) & (gap <= nearest + band["match"])
        b_, k_, t = v.shape[0], v.shape[2], min(8, gap.shape[-1])
        _, which = torch.topk(gap, t, dim=-1, largest=False)  # (b, C, K, t)
        listed = torch.gather(may, -1, which)
        whole = listed.sum(-1) == may.sum(-1)                # (b, C, K)
        flat = which.reshape(b_, c, k_ * t)
        mb = torch.gather(rn[sl], 2, flat[..., None].expand(-1, -1, -1, 4))
        listed = listed.reshape(b_, c, k_ * t)
        pair = _iou(mb, mb).masked_fill(
            ~(listed[..., :, None] & listed[..., None, :]), math.inf)
        pair = pair.view(b_, c, k_, t, k_, t).amin(dim=(3, 5))
        pair = pair.masked_fill(
            torch.eye(k_, dtype=torch.bool, device=dev)
            | ~(whole[..., :, None] & whole[..., None, :]), math.inf)
        excess = ((pair - thr - eps) / (1.0 - thr - eps)).clamp(0)
        worst["overlap"] = torch.maximum(worst["overlap"], torch.where(
            torch.isfinite(pair), excess, 0.0).amax())
        stood = may.any(dim=2)                               # (b, C, Q)
        covers = (stood[..., None, :] & (_iou(rn[sl], rn[sl]) > thr - eps)
                  & (rs[sl, ..., None, :] * rho >= rs[sl, ..., None])
                  ).any(-1)                                  # (b, C, Q)
        to_port = torch.where(v[..., None, :], gap.transpose(-1, -2),
                              far).amin(-1)                  # (b, C, Q)
        worst["held"] = torch.maximum(worst["held"], torch.where(
            sure[sl] & ~covers, to_port, 0.0).amax())
    out = {k: float(v) for k, v in worst.items()}
    out["det_gap"] = max(out.values())
    return out
