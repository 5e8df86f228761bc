"""Detection-loss dispatch, the ``detection_loss`` part of
``modelcompression_tpu/train/yolo_loss.py``.

The [region] family (YOLOv2) trains through ``region_loss``. The
multi-head [yolo] loss (YOLOv3/v4: ``yolo_loss``, GIoU/DIoU/CIoU,
``scale_x_y``, ``iou_thresh`` assignment) is not ported yet (ROADMAP
Queue 1 item 5).
"""

from __future__ import annotations

import torch

from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.train.region_loss import (
    RegionLossMetrics, region_loss,
)


def detection_loss(raw, targets: torch.Tensor, spec: NetworkSpec,
                   seen) -> RegionLossMetrics:
    """[region] specs -> ``region_loss`` on the single raw map. ``seen``
    gates [region]'s early prior loss."""
    if spec.is_multi_head:
        raise NotImplementedError(
            "the multi-head [yolo] loss (train/yolo_loss.yolo_loss) is not "
            "ported to the PyTorch package yet (ROADMAP Queue 1 item 5)")
    return region_loss(raw, targets, spec.region, seen)
