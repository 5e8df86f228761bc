"""Knowledge-distillation fine-tune, port of
``modelcompression_tpu/train/distill.py``.

The pruned or quantized student trains against the original teacher's
raw detection map beside the ground-truth loss (Hinton et al. 2015 soft
targets; objectness-gated detection form after Mehta & Ozturk 2018).

The teacher is BN-folded once when the plan is made, and its inference
forward (``models.darknet.forward_folded``, without the fused input
stage, as in the JAX package) runs inside the student's train step on
the same augmented batch. Its output enters the loss detached: no
backward reaches the teacher.

Loss on the raw (B, H, W, A*(5+C)) map, summed over cells and divided by
B (``region_loss``'s normalization); for multi-head [yolo] specs the same
map loss summed over the scales, matched one for one:

* objectness: MSE between teacher and student sigmoids, all cells;
* coords: MSE on (sigma(tx), sigma(ty), tw, th), gated per anchor by the
  teacher's objectness;
* class: temperature-T KL(teacher || student) on the softmax classes,
  scaled by T², gated the same way; sigmoid MSE where the head has no
  softmax ([region] softmax=0, every [yolo] head).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.core.precision import Precision
from modelcompression_tpu_torch.models.cfg import NetworkSpec, RegionLayer
from modelcompression_tpu_torch.models.darknet import (
    Params, fold_batchnorm, forward_folded,
)


@dataclasses.dataclass(frozen=True)
class DistillPlan:
    """Distillation plan of a fine-tune. ``teacher_params`` are BN-folded
    (``make_distill_plan`` folds them); ``weight`` blends the distillation
    loss into the total (total = detection + weight * distill)."""

    teacher_params: Params
    teacher_spec: NetworkSpec
    weight: float = 1.0
    temp: float = 1.0
    coord_scale: float = 1.0
    obj_scale: float = 1.0
    class_scale: float = 1.0


def make_distill_plan(teacher_params: Params, teacher_spec: NetworkSpec,
                      student_spec: NetworkSpec, *,
                      weight: float = 1.0, temp: float = 1.0,
                      coord_scale: float = 1.0, obj_scale: float = 1.0,
                      class_scale: float = 1.0,
                      folded: bool = False) -> DistillPlan:
    """Check that teacher and student share the detection geometry (head
    family, per-head anchor count, class count and anchor priors: the
    loss compares anchor slots one for one, and tw/th are offsets from
    the priors), and fold the teacher's BN. Spatial grids are checked by
    shape in the loss."""
    if teacher_spec.is_multi_head != student_spec.is_multi_head:
        raise ValueError(
            "teacher and student must be the same head family — raw-map "
            "distillation compares maps scale-for-scale ([region] vs "
            "[yolo] cannot be slot-matched)")
    if teacher_spec.is_multi_head:
        th = [teacher_spec.layers[i] for i in teacher_spec.head_indices()]
        sh = [student_spec.layers[i] for i in student_spec.head_indices()]
        if len(th) != len(sh):
            raise ValueError(
                f"teacher has {len(th)} [yolo] heads, student {len(sh)} — "
                "multi-head distillation matches scales one-for-one")
        for k, (t, s) in enumerate(zip(th, sh)):
            if (t.n, t.classes) != (s.n, s.classes):
                raise ValueError(
                    f"[yolo] head {k}: teacher ({t.n} anchors, "
                    f"{t.classes} classes) does not match student "
                    f"({s.n}, {s.classes})")
            if t.anchor_pairs != s.anchor_pairs:
                raise ValueError(
                    f"[yolo] head {k}: teacher and student anchor priors "
                    "differ — tw/th are offsets relative to this scale's "
                    "priors, so slot-matching needs identical pairs")
    else:
        tr, sr = teacher_spec.region, student_spec.region
        if (tr.num, tr.classes) != (sr.num, sr.classes):
            raise ValueError(
                f"teacher head ({tr.num} anchors, {tr.classes} classes) "
                f"does not match student head ({sr.num}, {sr.classes})")
        if tuple(tr.anchors) != tuple(sr.anchors):
            raise ValueError(
                "teacher and student anchor priors differ — raw-map "
                "distillation compares tw/th per anchor slot, which is "
                "only meaningful for identical priors")
    if temp <= 0:
        raise ValueError(f"temperature must be > 0, got {temp}")
    if not folded:
        with torch.no_grad():
            teacher_params = fold_batchnorm(teacher_params, teacher_spec)
    return DistillPlan(teacher_params=teacher_params,
                       teacher_spec=teacher_spec, weight=weight, temp=temp,
                       coord_scale=coord_scale, obj_scale=obj_scale,
                       class_scale=class_scale)


def teacher_forward(plan: DistillPlan, t_params: Params, x: torch.Tensor,
                    precision: Precision):
    """The teacher's inference forward on the (augmented) NHWC student
    batch, without autograd: the raw map, or a tuple of per-head maps."""
    with torch.no_grad():
        return forward_folded(t_params, x, plan.teacher_spec, precision)


def distill_loss(raw_s: torch.Tensor, raw_t: torch.Tensor,
                 region: RegionLayer, *, temp: float = 1.0,
                 coord_scale: float = 1.0, obj_scale: float = 1.0,
                 class_scale: float = 1.0) -> torch.Tensor:
    """Objectness-gated distillation loss on raw [region] maps (B, H, W,
    A*(5+C)); the teacher's map is detached here. A 0-dim tensor, exactly
    0 when student == teacher."""
    return _distill_loss_map(raw_s, raw_t, region.num, region.classes,
                             bool(region.softmax), temp=temp,
                             coord_scale=coord_scale, obj_scale=obj_scale,
                             class_scale=class_scale)


def detection_distill_loss(raw_s, raw_t, spec: NetworkSpec, *,
                           temp: float = 1.0, coord_scale: float = 1.0,
                           obj_scale: float = 1.0,
                           class_scale: float = 1.0) -> torch.Tensor:
    """``distill_loss`` for a [region] spec; for a multi-head [yolo] spec
    the map loss summed over the per-scale maps, with the sigmoid-MSE
    class term ([yolo] classes are independent sigmoids)."""
    if not spec.is_multi_head:
        return distill_loss(raw_s, raw_t, spec.region, temp=temp,
                            coord_scale=coord_scale, obj_scale=obj_scale,
                            class_scale=class_scale)
    heads = [spec.layers[i] for i in spec.head_indices()]
    assert len(raw_s) == len(raw_t) == len(heads)
    total = None
    for rs, rt, hl in zip(raw_s, raw_t, heads):
        term = _distill_loss_map(rs, rt, hl.n, hl.classes, False, temp=temp,
                                 coord_scale=coord_scale,
                                 obj_scale=obj_scale,
                                 class_scale=class_scale)
        total = term if total is None else total + term
    return total


def _distill_loss_map(raw_s: torch.Tensor, raw_t: torch.Tensor,
                      a: int, c: int, softmax: bool, *, temp: float = 1.0,
                      coord_scale: float = 1.0, obj_scale: float = 1.0,
                      class_scale: float = 1.0) -> torch.Tensor:
    """One raw map's loss: ``a`` anchors, ``c`` classes, softmax or
    multi-label-sigmoid class slots."""
    b, h, w, _ = raw_s.shape
    rs = raw_s.reshape(b, h, w, a, 5 + c).float()
    rt = raw_t.detach().reshape(b, h, w, a, 5 + c).float()

    xy_s, xy_t = torch.sigmoid(rs[..., 0:2]), torch.sigmoid(rt[..., 0:2])
    wh_s, wh_t = rs[..., 2:4], rt[..., 2:4]
    obj_s, obj_t = torch.sigmoid(rs[..., 4]), torch.sigmoid(rt[..., 4])

    gate = obj_t  # (B,H,W,A): the teacher's belief there is an object
    coord = torch.sum(gate * (torch.sum((xy_s - xy_t) ** 2, dim=-1)
                              + torch.sum((wh_s - wh_t) ** 2, dim=-1)))
    obj = torch.sum((obj_s - obj_t) ** 2)

    if softmax:
        # KL(teacher || student) at temperature T, scaled by T² so the
        # soft-target gradient magnitude stays T-independent (Hinton)
        logp_s = F.log_softmax(rs[..., 5:] / temp, dim=-1)
        logp_t = F.log_softmax(rt[..., 5:] / temp, dim=-1)
        kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_s), dim=-1)
        cls = (temp ** 2) * torch.sum(gate * kl)
    else:
        ps, pt = torch.sigmoid(rs[..., 5:]), torch.sigmoid(rt[..., 5:])
        cls = torch.sum(gate * torch.sum((ps - pt) ** 2, dim=-1))

    total = coord_scale * coord + obj_scale * obj + class_scale * cls
    return total / b
