"""Fixed-shape per-class NMS, port of
``modelcompression_tpu/evaluation/nms.py``.

Production path (``nms_topk`` and its per-class / prefiltered forms):
greedy NMS over the top-K scoring candidates. Sort the candidates once,
compute ONE (K, K) pairwise criterion matrix (IoU, or IoU minus the DIoU
penalty), then resolve suppression with a K-step loop over a boolean live
mask. The JAX ``vmap`` over batch and class becomes explicit leading dims
``(..., N)``, and its ``lax.scan`` / ``fori_loop`` a K-step Python loop
over tensors: nothing in a loop reads a device value on the host, so a
CUDA step is enqueued without waiting.

The other variants, each as in the JAX package:

* ``nms_padded`` (and ``*_nms_padded``): exact greedy NMS over ALL N
  candidates, K serial argmax rounds, each suppressing over all N.
* ``soft_nms_topk`` (and ``*_soft_nms``): Soft-NMS over the top K, K
  serial argmax rounds that decay scores (Gaussian or linear).
* ``diou=True``: DIoU-NMS, suppress on ``IoU - (rho^2/c^2)^beta``.
* ``exact_prefilter``: kept for parity with the JAX package, where False
  takes ``lax.approx_max_k`` to 4K candidates before the exact top-K.
  ``approx_max_k`` has no counterpart on this device, so False selects the
  exact stable sort, as JAX's own CPU lowering of ``approx_max_k`` does.
* ``impl='bisect'`` prefilter (``batched_bisect_prefilter``, named as in
  the JAX package): the class-agnostic top-N' by max class score with the
  weight masks' rule (``ops/cuda_topk.prune_flat``, one segment per
  image): on CUDA tensors it launches the radix-select, tie-count and
  apply kernels.

Tie order: ``lax.top_k`` is stable (equal scores keep the lower index
first), the order greedy argmax visits them. ``torch.topk`` makes no such
promise on CUDA, so selection here is ``torch.sort(descending=True,
stable=True)`` and a slice (``_topk_stable``). ``torch.argmax`` returns
the first maximal index, as ``jnp.argmax`` does.

Semantics: the top-K path equals classic greedy NMS whenever at most K
candidates exceed ``score_thresh``; above that, greedy NMS over the K
best.
"""

from __future__ import annotations

from typing import Tuple

import torch

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Top-k along the last dim, sorted descending, ties lower-index
    first (``lax.top_k`` order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (..., N, D), idx (..., K) -> (..., K, D)."""
    return torch.gather(t, -2, idx[..., None].expand(*idx.shape,
                                                     t.shape[-1]))


def _pad_slots(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, k: int, max_out: int) -> Result:
    """Pad K output slots to the requested static size."""
    if k < max_out:
        pad = max_out - k
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        scores = torch.nn.functional.pad(scores, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return boxes, scores, valid


def iou_corners(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one corner box (..., 4) against (..., N, 4) -> (..., N)."""
    b = box[..., None, :]
    x1 = torch.maximum(b[..., 0], boxes[..., 0])
    y1 = torch.maximum(b[..., 1], boxes[..., 1])
    x2 = torch.minimum(b[..., 2], boxes[..., 2])
    y2 = torch.minimum(b[..., 3], boxes[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area = (torch.clamp(b[..., 2] - b[..., 0], min=0)
            * torch.clamp(b[..., 3] - b[..., 1], min=0))
    areas = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
             * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    union = area + areas - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _penalty(rho2: torch.Tensor, c2: torch.Tensor,
             beta: float) -> torch.Tensor:
    pen = torch.where(c2 > 0, rho2 / c2, torch.zeros_like(rho2))
    return pen if beta == 1.0 else pen ** beta


def diou_penalty(box: torch.Tensor, boxes: torch.Tensor,
                 beta: float = 1.0) -> torch.Tensor:
    """DIoU center-distance penalty (rho^2/c^2)^beta (Zheng et al. 2020;
    darknet's diounms ``beta_nms`` exponent) of one corner box (..., 4)
    against (..., N, 4): squared center distance over the squared
    diagonal of the smallest enclosing box. beta=1 is the paper form."""
    b = box[..., None, :]
    cx, cy = (b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2
    cxs = (boxes[..., 0] + boxes[..., 2]) / 2
    cys = (boxes[..., 1] + boxes[..., 3]) / 2
    rho2 = (cx - cxs) ** 2 + (cy - cys) ** 2
    ex1 = torch.minimum(b[..., 0], boxes[..., 0])
    ey1 = torch.minimum(b[..., 1], boxes[..., 1])
    ex2 = torch.maximum(b[..., 2], boxes[..., 2])
    ey2 = torch.maximum(b[..., 3], boxes[..., 3])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    return _penalty(rho2, c2, beta)


def pairwise_diou_penalty(a: torch.Tensor, b: torch.Tensor,
                          beta: float = 1.0) -> torch.Tensor:
    """DIoU penalty of (..., N, 4) against (..., M, 4) -> (..., N, M)."""
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    acx, acy = (a_[..., 0] + a_[..., 2]) / 2, (a_[..., 1] + a_[..., 3]) / 2
    bcx, bcy = (b_[..., 0] + b_[..., 2]) / 2, (b_[..., 1] + b_[..., 3]) / 2
    rho2 = (acx - bcx) ** 2 + (acy - bcy) ** 2
    ex1 = torch.minimum(a_[..., 0], b_[..., 0])
    ey1 = torch.minimum(a_[..., 1], b_[..., 1])
    ex2 = torch.maximum(a_[..., 2], b_[..., 2])
    ey2 = torch.maximum(a_[..., 3], b_[..., 3])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    return _penalty(rho2, c2, beta)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., N, 4) against (..., M, 4) corner boxes -> (..., N, M)."""
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    x1 = torch.maximum(a_[..., 0], b_[..., 0])
    y1 = torch.maximum(a_[..., 1], b_[..., 1])
    x2 = torch.minimum(a_[..., 2], b_[..., 2])
    y2 = torch.minimum(a_[..., 3], b_[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor,
               iou_thresh: float = 0.45, score_thresh: float = 0.0,
               max_out: int = 100, diou: bool = False,
               diou_beta: float = 1.0) -> Result:
    """Exact greedy NMS with a static output size, batched over any
    leading dims: K = ``max_out`` rounds, each picks the argmax of the live
    scores over ALL N candidates (emitting nothing once it is 0) and
    zeroes every live candidate whose IoU (minus the DIoU penalty with
    ``diou``) with the pick exceeds ``iou_thresh``.

    boxes (..., N, 4) corner format (may be an expanded view); scores
    (..., N), entries <= score_thresh absent. Returns (..., K, 4) boxes,
    (..., K) scores (0 where invalid), (..., K) valid."""
    live = torch.where(scores > score_thresh, scores,
                       torch.zeros_like(scores))
    out_idx, out_scores = [], []
    for _ in range(max_out):
        j = torch.argmax(live, dim=-1, keepdim=True)          # (..., 1)
        s = torch.gather(live, -1, j)
        keep = s > 0
        out_idx.append(torch.where(keep, j, -1))
        out_scores.append(torch.where(keep, s, torch.zeros_like(s)))
        pick = _gather_rows(boxes, j)[..., 0, :]               # (..., 4)
        crit = iou_corners(pick, boxes)
        if diou:
            crit = crit - diou_penalty(pick, boxes, diou_beta)
        live = torch.where((crit > iou_thresh) & keep,
                           torch.zeros_like(live), live)
        live = live.scatter(-1, j, 0.0)
    idx = torch.cat(out_idx, dim=-1)
    valid = idx >= 0
    sel = _gather_rows(boxes, idx.clamp_min(0))
    sel = torch.where(valid[..., None], sel, torch.zeros_like(sel))
    return sel, torch.cat(out_scores, dim=-1), valid


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor,
             iou_thresh: float = 0.45, score_thresh: float = 0.0,
             max_out: int = 100, exact_prefilter: bool = True,
             diou: bool = False, diou_beta: float = 1.0) -> Result:
    """Greedy NMS over the top-``max_out`` candidates, batched over any
    leading dims (module docstring: ``exact_prefilter``, ``diou``).

    boxes (..., N, 4) corner format (may be an expanded view); scores
    (..., N), entries <= score_thresh treated as absent. Returns
    (..., K, 4) boxes, (..., K) scores (0 where invalid), (..., K) valid,
    score-descending, K = max_out."""
    k = min(max_out, scores.shape[-1])
    s = torch.where(scores > score_thresh, scores, torch.zeros_like(scores))
    vals, idx = _topk_stable(s, k)
    cand = _gather_rows(boxes, idx)                   # (..., K, 4)
    crit = pairwise_iou(cand, cand)                   # (..., K, K)
    if diou:  # still a static pairwise criterion: the same one-shot loop
        crit = crit - pairwise_diou_penalty(cand, cand, diou_beta)
    suppress = crit > iou_thresh
    later = torch.triu(torch.ones(k, k, dtype=torch.bool,
                                  device=scores.device), diagonal=1)
    live = vals > 0
    keep = []
    for i in range(k):
        keep_i = live[..., i]
        keep.append(keep_i)
        live = live & ~(suppress[..., i, :] & later[i] & keep_i[..., None])
    valid = torch.stack(keep, dim=-1) & (vals > 0)
    out_scores = torch.where(valid, vals, torch.zeros_like(vals))
    out_boxes = torch.where(valid[..., None], cand, torch.zeros_like(cand))
    return _pad_slots(out_boxes, out_scores, valid, k, max_out)


def _per_class(fn, boxes: torch.Tensor, class_scores: torch.Tensor,
               *args) -> Result:
    """Run ``fn(boxes, scores, *args)`` independently per class: boxes
    (..., N, 4), class_scores (..., N, C) -> (..., C, K, ...)."""
    c = class_scores.shape[-1]
    b = boxes[..., None, :, :].expand(*boxes.shape[:-2], c,
                                      *boxes.shape[-2:])
    return fn(b, class_scores.transpose(-1, -2), *args)


def per_class_nms(boxes: torch.Tensor, class_scores: torch.Tensor,
                  iou_thresh: float = 0.45, score_thresh: float = 1e-3,
                  max_out: int = 100, exact_prefilter: bool = True,
                  diou: bool = False, diou_beta: float = 1.0) -> Result:
    """NMS independently per class: boxes (..., N, 4), class_scores
    (..., N, C) -> (..., C, K, 4), (..., C, K), (..., C, K)."""
    return _per_class(nms_topk, boxes, class_scores, iou_thresh,
                      score_thresh, max_out, exact_prefilter, diou,
                      diou_beta)


def batched_per_class_nms(boxes: torch.Tensor, class_scores: torch.Tensor,
                          iou_thresh: float = 0.45,
                          score_thresh: float = 1e-3,
                          max_out: int = 100, exact_prefilter: bool = True,
                          diou: bool = False,
                          diou_beta: float = 1.0) -> Result:
    """(B, N, 4), (B, N, C) -> (B, C, K, ...)."""
    return per_class_nms(boxes, class_scores, iou_thresh, score_thresh,
                         max_out, exact_prefilter, diou, diou_beta)


def per_class_nms_prefiltered(boxes: torch.Tensor,
                              class_scores: torch.Tensor,
                              iou_thresh: float = 0.45,
                              score_thresh: float = 1e-3,
                              max_out: int = 100,
                              prefilter: int = 256,
                              exact_prefilter: bool = True,
                              diou: bool = False,
                              diou_beta: float = 1.0) -> Result:
    """Per-class NMS behind a class-agnostic candidate prefilter: one
    top-``prefilter`` selection on each candidate's max class score cuts N
    before the per-class sorts. Exactly ``per_class_nms`` whenever at most
    ``prefilter`` candidates have any class score above ``score_thresh``.
    boxes (..., N, 4), class_scores (..., N, C) -> (..., C, K, ...)."""
    n = boxes.shape[-2]
    np_ = min(prefilter, n)
    m = class_scores.amax(dim=-1)                             # (..., N)
    m = torch.where(m > score_thresh, m, torch.zeros_like(m))
    vals, idx = _topk_stable(m, np_)                          # (..., N')
    b2 = _gather_rows(boxes, idx)                             # (..., N', 4)
    cs2 = _gather_rows(class_scores, idx)                     # (..., N', C)
    cs2 = torch.where(vals[..., None] > 0, cs2, torch.zeros_like(cs2))
    return per_class_nms(b2, cs2, iou_thresh, score_thresh, max_out,
                         exact_prefilter, diou, diou_beta)


def batched_bisect_prefilter(boxes: torch.Tensor, class_scores: torch.Tensor,
                             score_thresh: float, prefilter: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The class-agnostic candidate prefilter as a batched segmented
    select instead of a sort (the JAX package's segmented bisection; here
    a radix select finds the same threshold): per image, keep the top-``prefilter``
    candidates by max class score with the weight masks' rule
    (``ops/cuda_topk.prune_flat`` with ``return_mask``, one contiguous
    segment per image, ``n_zero = N - N'``: ties at the N'-th value are
    dropped lowest index first), then compact the survivors into N' slots
    per image with a cumsum-position scatter, in candidate-index order.

    On CUDA tensors ``prune_flat`` launches the radix-select kernel 5
    times and the tie-count and apply kernels once each; on CPU tensors
    it runs their plain versions. Set-equal to the top-k prefilter while at most
    N' candidates of an image clear ``score_thresh``; above that the kept
    sets can differ only on ties at the N'-th value (top-k keeps the
    lowest indices).

    boxes (B, N, 4), class_scores (B, N, C) -> (B, N', 4) boxes and
    (B, N', C) class scores, zeroed where the slot's max score is not
    above the threshold."""
    from modelcompression_tpu_torch.ops.cuda_topk import prune_flat
    bb, n, _ = class_scores.shape
    np_ = min(prefilter, n)
    dev = class_scores.device
    m = class_scores.amax(dim=-1).float()                    # (B, N)
    m = torch.where(m > score_thresh, m, torch.zeros_like(m))
    seg = torch.arange(bb * n, device=dev, dtype=torch.int32) // n
    n_zero = torch.full((bb,), n - np_, dtype=torch.int64, device=dev)
    keep = prune_flat(m.reshape(-1), seg, n_zero, bb,
                      return_mask=True).view(bb, n) != 0
    # kept candidates go to their cumsum position; dropped ones to a
    # spare slot N' that is cut off. Exactly N' are kept per image (zeros
    # included when fewer are live; their class scores are zeroed below)
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, np_)
    cols = torch.arange(n, device=dev).expand(bb, n)
    idx = torch.zeros((bb, np_ + 1), dtype=torch.int64,
                      device=dev).scatter_(1, pos, cols)[:, :np_]
    vals = torch.gather(m, 1, idx)                           # (B, N')
    b2 = _gather_rows(boxes, idx)
    cs2 = _gather_rows(class_scores, idx)
    cs2 = torch.where(vals[..., None] > 0, cs2, torch.zeros_like(cs2))
    return b2, cs2


def batched_per_class_nms_prefiltered(boxes: torch.Tensor,
                                      class_scores: torch.Tensor,
                                      iou_thresh: float = 0.45,
                                      score_thresh: float = 1e-3,
                                      max_out: int = 100,
                                      prefilter: int = 256,
                                      exact_prefilter: bool = True,
                                      diou: bool = False,
                                      diou_beta: float = 1.0,
                                      impl: str = "topk") -> Result:
    """(B, N, 4), (B, N, C) -> (B, C, K, ...). ``impl``: 'topk' (the
    per-image stable sort) or 'bisect' (``batched_bisect_prefilter``, the
    sort-free segmented select; same exactness condition)."""
    if impl == "bisect":
        b2, cs2 = batched_bisect_prefilter(boxes, class_scores,
                                           score_thresh, prefilter)
        return per_class_nms(b2, cs2, iou_thresh, score_thresh, max_out,
                             exact_prefilter, diou, diou_beta)
    if impl != "topk":
        raise ValueError(f"impl must be 'topk' or 'bisect', got {impl!r}")
    return per_class_nms_prefiltered(boxes, class_scores, iou_thresh,
                                     score_thresh, max_out, prefilter,
                                     exact_prefilter, diou, diou_beta)


def soft_nms_topk(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_thresh: float = 0.3, score_thresh: float = 1e-3,
                  max_out: int = 100, sigma: float = 0.5,
                  linear: bool = False) -> Result:
    """Soft-NMS (Bodla et al. 2017) over the top-``max_out`` candidates,
    batched over any leading dims: each selection decays the remaining
    scores, Gaussian ``s *= exp(-iou^2 / sigma)`` or linear ``s *= 1 - iou``
    where ``iou > iou_thresh``. One stable top-K prefilter and one (K, K)
    IoU matrix, then K serial argmax rounds (decayed scores change the
    visit order). A pick whose decayed score is <= ``score_thresh`` is not
    emitted. Exact against the full-N algorithm whenever at most K
    candidates exceed ``score_thresh``.

    Returns (..., K, 4) boxes (0 where invalid), (..., K) DECAYED scores
    in emission order (0 where invalid), (..., K) valid."""
    k = min(max_out, scores.shape[-1])
    s = torch.where(scores > score_thresh, scores, torch.zeros_like(scores))
    vals, idx = _topk_stable(s, k)
    cand = _gather_rows(boxes, idx)                   # (..., K, 4)
    iou = pairwise_iou(cand, cand)                    # (..., K, K)
    if linear:
        w = torch.where(iou > iou_thresh, 1.0 - iou, torch.ones_like(iou))
    else:
        w = torch.exp(-(iou * iou) / sigma)
    live = vals
    out_idx, out_scores = [], []
    for _ in range(k):
        j = torch.argmax(live, dim=-1, keepdim=True)          # (..., 1)
        sj = torch.gather(live, -1, j)
        keep = sj > score_thresh
        out_idx.append(torch.where(keep, j, -1))
        out_scores.append(torch.where(keep, sj, torch.zeros_like(sj)))
        # decay the survivors by the pick's weight row; retire the pick
        decay = _gather_rows(w, j)[..., 0, :].scatter(-1, j, 0.0)
        live = torch.where(keep, live * decay, live)
    oidx = torch.cat(out_idx, dim=-1)
    valid = oidx >= 0
    out_boxes = _gather_rows(cand, oidx.clamp_min(0))
    out_boxes = torch.where(valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    return _pad_slots(out_boxes, torch.cat(out_scores, dim=-1), valid, k,
                      max_out)


def per_class_soft_nms(boxes: torch.Tensor, class_scores: torch.Tensor,
                       iou_thresh: float = 0.3, score_thresh: float = 1e-3,
                       max_out: int = 100, sigma: float = 0.5,
                       linear: bool = False) -> Result:
    """Soft-NMS independently per class: (..., N, 4), (..., N, C) ->
    (..., C, K, ...)."""
    return _per_class(soft_nms_topk, boxes, class_scores, iou_thresh,
                      score_thresh, max_out, sigma, linear)


def batched_per_class_soft_nms(boxes: torch.Tensor,
                               class_scores: torch.Tensor,
                               iou_thresh: float = 0.3,
                               score_thresh: float = 1e-3,
                               max_out: int = 100, sigma: float = 0.5,
                               linear: bool = False) -> Result:
    """(B, N, 4), (B, N, C) -> (B, C, K, ...)."""
    return per_class_soft_nms(boxes, class_scores, iou_thresh,
                              score_thresh, max_out, sigma, linear)


def per_class_nms_padded(boxes: torch.Tensor, class_scores: torch.Tensor,
                         iou_thresh: float = 0.45,
                         score_thresh: float = 1e-3, max_out: int = 100,
                         diou: bool = False,
                         diou_beta: float = 1.0) -> Result:
    """Exact greedy NMS per class over ALL N candidates (``nms_padded``),
    no top-K candidate prefilter: correct even when more than
    ``max_out`` candidates clear ``score_thresh``. Only the output is
    capped at ``max_out`` survivors per class. (..., C, K, ...)."""
    return _per_class(nms_padded, boxes, class_scores, iou_thresh,
                      score_thresh, max_out, diou, diou_beta)


def batched_per_class_nms_padded(boxes: torch.Tensor,
                                 class_scores: torch.Tensor,
                                 iou_thresh: float = 0.45,
                                 score_thresh: float = 1e-3,
                                 max_out: int = 100, diou: bool = False,
                                 diou_beta: float = 1.0) -> Result:
    """(B, N, 4), (B, N, C) -> (B, C, K, ...)."""
    return per_class_nms_padded(boxes, class_scores, iou_thresh,
                                score_thresh, max_out, diou, diou_beta)
