"""COCO JSON annotation loading, port of
``modelcompression_tpu/data/coco.py``.

Real COCO distributions ship ``instances_*.json``; this module makes such
a tree a drop-in ``--data`` argument (stdlib ``json`` only):

* ``categories`` ids are sparse (1..90 with gaps in real COCO); they are
  remapped to contiguous class indices by ascending category id, and the
  class-name list is returned beside the samples.
* ``bbox`` is ``[x_min, y_min, w, h]`` in absolute pixels; converted to
  the normalized center format every Sample carries.
* ``iscrowd`` annotations map to ``difficult``, which the mAP protocol
  ignores for TP/FP accounting.
* degenerate boxes (w<=0 or h<=0 after clipping) are dropped.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from modelcompression_tpu_torch.data.voc import Sample


def _default_image_dir(ann_file: str) -> str:
    """COCO layout convention: ``<root>/annotations/instances_<split>.json``
    with images at ``<root>/<split>/``; else the annotation file's own
    directory."""
    stem = os.path.splitext(os.path.basename(ann_file))[0]
    split = stem.rpartition("_")[2]  # instances_val2017 -> val2017
    root = os.path.dirname(os.path.dirname(os.path.abspath(ann_file)))
    cand = os.path.join(root, split)
    return cand if split and os.path.isdir(cand) else \
        os.path.dirname(os.path.abspath(ann_file))


def load_coco_json(ann_file: str, image_dir: Optional[str] = None
                   ) -> Tuple[List[Sample], List[str]]:
    """Load a COCO ``instances_*.json`` into (samples, class_names).

    ``image_dir``: directory holding the images named by each image's
    ``file_name`` (default: ``_default_image_dir``). Images missing on
    disk raise at ``Sample.load_image`` time, not here.
    """
    with open(ann_file) as f:
        coco = json.load(f)
    for key in ("images", "annotations", "categories"):
        if key not in coco:
            raise ValueError(f"{ann_file}: not a COCO instances file "
                             f"(missing '{key}')")
    image_dir = image_dir or _default_image_dir(ann_file)

    cats = sorted(coco["categories"], key=lambda c: int(c["id"]))
    names = [c["name"] for c in cats]
    cat_to_idx = {int(c["id"]): i for i, c in enumerate(cats)}

    per_image: Dict[int, List[Tuple[int, float, float, float, float, bool]]]
    per_image = {}
    for a in coco["annotations"]:
        img_id = int(a["image_id"])
        cid = int(a["category_id"])
        if cid not in cat_to_idx:
            raise ValueError(f"annotation {a.get('id')} references unknown "
                             f"category id {cid}")
        x, y, w, h = (float(v) for v in a["bbox"])
        per_image.setdefault(img_id, []).append(
            (cat_to_idx[cid], x, y, w, h, bool(a.get("iscrowd", 0))))

    samples: List[Sample] = []
    for im in coco["images"]:
        img_id = int(im["id"])
        iw, ih = float(im["width"]), float(im["height"])
        rows, diff = [], []
        for cls, x, y, w, h, crowd in per_image.get(img_id, ()):
            # clip to the image, drop degenerate boxes
            x1, y1 = max(x, 0.0), max(y, 0.0)
            x2, y2 = min(x + w, iw), min(y + h, ih)
            if x2 - x1 <= 0 or y2 - y1 <= 0:
                continue
            rows.append([cls, (x1 + x2) / 2 / iw, (y1 + y2) / 2 / ih,
                         (x2 - x1) / iw, (y2 - y1) / ih])
            diff.append(crowd)
        labels = (np.asarray(rows, np.float32) if rows
                  else np.zeros((0, 5), np.float32))
        samples.append(Sample(
            image_path=os.path.join(image_dir, im["file_name"]),
            image_id=os.path.splitext(im["file_name"])[0],
            labels=labels,
            difficult=np.asarray(diff, bool)))
    if not samples:
        raise ValueError(f"{ann_file}: no images")
    return samples, names
