"""Synthetic VOC-style dataset fixtures, port of
``modelcompression_tpu/data/fixtures.py``.

No dataset ships with the repository, so tests and smoke runs use
generated data: images holding axis-aligned solid rectangles whose class
sets their colour. The same ``np.random.default_rng(seed)`` stream as the
JAX package's writers, so the same seed writes the same labels and the
same pixels.

``make_fake_voc`` writes PNG with the port's own writer (``data/png.py``)
and needs no cv2. The devkit and COCO trees hold JPEG files, as the real
datasets do; they are written with cv2, imported when called.
``tiny_region_cfg``, ``tiny_yolo3_cfg`` and ``tiny_yolo4_cfg`` return cfg
text equal to the JAX package's for the same arguments.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from modelcompression_tpu_torch.data.png import write_png
from modelcompression_tpu_torch.data.voc import import_cv2

FIXTURE_CLASSES = ("redbox", "greenbox", "bluebox")
_COLORS = ((220, 40, 40), (40, 200, 40), (40, 60, 220))


def _background(rng, h: int, w: int) -> np.ndarray:
    img = np.full((h, w, 3), 110, np.uint8)
    noise = rng.integers(0, 30, (h, w, 3), dtype=np.uint8)
    return np.clip(img.astype(np.int16) + noise - 15, 0, 255) \
        .astype(np.uint8)


def _box(rng, h: int, w: int, n_classes: int):
    """(cls, x1, y1, bw, bh), drawn in the JAX writers' order."""
    cls = int(rng.integers(0, n_classes))
    bw = int(rng.integers(w // 8, w // 3))
    bh = int(rng.integers(h // 8, h // 3))
    x1 = int(rng.integers(0, w - bw))
    y1 = int(rng.integers(0, h - bh))
    return cls, x1, y1, bw, bh


def make_fake_voc(root: str, n_images: int = 8, image_size: int = 416,
                  max_objects: int = 3, seed: int = 0,
                  classes: Tuple[str, ...] = FIXTURE_CLASSES) -> str:
    """Write a synthetic dataset; returns path to the ``.data`` cfg file.

    Layout: root/images/*.png, root/labels/*.txt, root/names.list,
    root/all.list, root/fixture.data.
    """
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    lbl_dir = os.path.join(root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)

    list_lines: List[str] = []
    for i in range(n_images):
        h = w = image_size
        img = _background(rng, h, w)
        rows = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cls, x1, y1, bw, bh = _box(rng, h, w, len(classes))
            img[y1:y1 + bh, x1:x1 + bw] = _COLORS[cls % len(_COLORS)]
            rows.append([cls, (x1 + bw / 2) / w, (y1 + bh / 2) / h,
                         bw / w, bh / h])
        name = f"img{i:04d}"
        path = os.path.join(img_dir, f"{name}.png")
        write_png(path, img)
        np.savetxt(os.path.join(lbl_dir, f"{name}.txt"),
                   np.asarray(rows, np.float32), fmt="%.6f")
        list_lines.append(path)

    names_path = os.path.join(root, "names.list")
    with open(names_path, "w") as f:
        f.write("\n".join(classes) + "\n")
    list_path = os.path.join(root, "all.list")
    with open(list_path, "w") as f:
        f.write("\n".join(list_lines) + "\n")
    data_path = os.path.join(root, "fixture.data")
    with open(data_path, "w") as f:
        f.write(f"classes={len(classes)}\ntrain={list_path}\n"
                f"valid={list_path}\nnames={names_path}\n")
    return data_path


def make_fake_voc_devkit(root: str, n_images: int = 8,
                         image_size: int = 416, max_objects: int = 3,
                         seed: int = 0, year: str = "2007",
                         image_sets: Tuple[str, ...] = ("test", "trainval"),
                         class_names: Tuple[str, ...] = ("aeroplane",
                                                         "bicycle", "bird"),
                         ) -> str:
    """Write a VOCdevkit-shaped synthetic dataset; returns the devkit root
    to pass as ``--data`` (the directory containing ``VOC<year>/``).

    The real Pascal devkit's layout: ``VOC2007/JPEGImages/<id>.jpg``,
    ``VOC2007/Annotations/<id>.xml`` with 1-based inclusive-pixel
    ``bndbox`` coords and VOC class ``name`` tags, and
    ``VOC2007/ImageSets/Main/<set>.txt`` id lists. About one object in
    four is flagged ``difficult``. Needs cv2 (JPEG).
    """
    cv2 = import_cv2("writing the devkit fixture's JPEG images")
    rng = np.random.default_rng(seed)
    vdir = os.path.join(root, f"VOC{year}")
    img_dir = os.path.join(vdir, "JPEGImages")
    ann_dir = os.path.join(vdir, "Annotations")
    set_dir = os.path.join(vdir, "ImageSets", "Main")
    for d in (img_dir, ann_dir, set_dir):
        os.makedirs(d, exist_ok=True)

    ids = []
    for i in range(n_images):
        h = w = image_size
        img = _background(rng, h, w)
        objs = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cls, x1, y1, bw, bh = _box(rng, h, w, len(class_names))
            img[y1:y1 + bh, x1:x1 + bw] = _COLORS[cls % len(_COLORS)]
            difficult = int(rng.integers(0, 4) == 0)
            objs.append((class_names[cls], x1, y1, x1 + bw, y1 + bh,
                         difficult))
        img_id = f"{i:06d}"
        ids.append(img_id)
        cv2.imwrite(os.path.join(img_dir, f"{img_id}.jpg"),
                    img[:, :, ::-1])  # RGB -> BGR for cv2
        obj_xml = "".join(
            f"  <object>\n    <name>{n}</name>\n"
            f"    <difficult>{d}</difficult>\n"
            "    <bndbox>\n"
            # devkit convention: 1-based inclusive pixel coords
            f"      <xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>"
            f"<xmax>{x2}</xmax><ymax>{y2}</ymax>\n"
            "    </bndbox>\n  </object>\n"
            for n, x1, y1, x2, y2, d in objs)
        with open(os.path.join(ann_dir, f"{img_id}.xml"), "w") as f:
            f.write(
                "<annotation>\n"
                f"  <filename>{img_id}.jpg</filename>\n"
                f"  <size><width>{w}</width><height>{h}</height>"
                "<depth>3</depth></size>\n"
                f"{obj_xml}"
                "</annotation>\n")

    for image_set in image_sets:
        with open(os.path.join(set_dir, f"{image_set}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return root


def make_fake_coco(root: str, n_images: int = 8, image_size: int = 416,
                   max_objects: int = 3, seed: int = 0,
                   split: str = "val2017",
                   class_names: Tuple[str, ...] = FIXTURE_CLASSES) -> str:
    """Write a COCO-shaped synthetic dataset; returns the path of the
    ``instances_<split>.json`` to pass as ``--data``.

    The real COCO layout: ``<root>/annotations/instances_<split>.json`` +
    ``<root>/<split>/<file_name>`` images. Category ids are sparse (1, 3,
    7, ...) to exercise the contiguous-index remapping, and about one
    object in four is flagged ``iscrowd``. Needs cv2 (JPEG).
    """
    cv2 = import_cv2("writing the COCO fixture's JPEG images")
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, split)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    sparse_ids = [1 + 2 * k + (k > 1) for k in range(len(class_names))]
    coco = {
        "images": [], "annotations": [],
        "categories": [{"id": cid, "name": n}
                       for cid, n in zip(sparse_ids, class_names)],
    }
    ann_id = 1
    for i in range(n_images):
        h = w = image_size
        img = _background(rng, h, w)
        file_name = f"{i:012d}.jpg"
        coco["images"].append({"id": i + 1, "file_name": file_name,
                               "width": w, "height": h})
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cls, x1, y1, bw, bh = _box(rng, h, w, len(class_names))
            img[y1:y1 + bh, x1:x1 + bw] = _COLORS[cls % len(_COLORS)]
            coco["annotations"].append({
                "id": ann_id, "image_id": i + 1,
                "category_id": sparse_ids[cls],
                "bbox": [float(x1), float(y1), float(bw), float(bh)],
                "area": float(bw * bh),
                "iscrowd": int(rng.integers(0, 4) == 0),
            })
            ann_id += 1
        cv2.imwrite(os.path.join(img_dir, file_name), img[:, :, ::-1])

    ann_path = os.path.join(ann_dir, f"instances_{split}.json")
    with open(ann_path, "w") as f:
        json.dump(coco, f)
    return ann_path


def tiny_region_cfg(num_classes: int = 3, width: int = 416,
                    height: int = 416) -> str:
    """A minimal fast Tiny-YOLO-style cfg for fixture integration tests
    (3 convs + pools down to stride 32)."""
    filters = 5 * (5 + num_classes)
    return f"""
[net]
batch=4
subdivisions=1
width={width}
height={height}
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
max_batches=500
policy=constant

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
size=1
stride=1
pad=1
filters={filters}
activation=linear

[region]
anchors = 1.08,1.19,  3.42,4.41,  6.63,11.38,  9.42,5.11,  16.62,10.52
bias_match=1
classes={num_classes}
coords=4
num=5
softmax=1
jitter=.2
rescore=1
object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1
absolute=1
thresh=.6
random=0
"""


def tiny_yolo3_cfg(num_classes: int = 3, width: int = 64,
                   height: int = 64) -> str:
    """A minimal YOLOv3-FAMILY cfg for fixture tests: exercises every
    v3-only layer type — [shortcut] residual add, [upsample], a 2-scale
    FPN with route-concat, and two [yolo] heads with anchor masks
    (anchors in network-input pixels). Downsamples to stride 8 (coarse
    head) / 4 (fine head)."""
    det = 2 * (5 + num_classes)
    return f"""
[net]
batch=4
subdivisions=1
width={width}
height={height}
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
max_batches=500
policy=constant

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=48
size=1
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters={det}
activation=linear

[yolo]
mask = 2,3
anchors = 8,8,  16,16,  24,24,  48,48
classes={num_classes}
num=4
jitter=.3
ignore_thresh = .7
truth_thresh = 1
random=0

[route]
layers=-3

[convolutional]
batch_normalize=1
filters=24
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1, 6

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters={det}
activation=linear

[yolo]
mask = 0,1
anchors = 8,8,  16,16,  24,24,  48,48
classes={num_classes}
num=4
jitter=.3
ignore_thresh = .7
truth_thresh = 1
random=0
"""


def tiny_yolo4_cfg(num_classes: int = 3, width: int = 64,
                   height: int = 64, iou_loss: str = "mse",
                   iou_normalizer: float = 0.07,
                   chmul: int = 1) -> str:
    """A minimal YOLOv4-TINY-family cfg for fixture tests: exercises the
    v4-only pieces — a CSP block ([route] groups=2 group_id=1 split,
    partial concat, transition, full concat), mish activation, and two
    scale_x_y=1.05 [yolo] heads — on top of the v3 machinery (upsample,
    route-concat FPN). Downsamples to stride 4 (coarse head) / 2.

    ``iou_loss="ciou"`` switches both heads to the canonical v4 training
    loss (the upstream yolov4-tiny.cfg keys: iou_loss=ciou,
    iou_normalizer, cls_normalizer=1.0) — the learnability/recovery
    fixtures train with it so the family's accuracy evidence uses the
    loss the family actually ships with. Default stays "mse" so tests
    that pin v3-form loss values are unaffected."""
    det = 2 * (5 + num_classes)
    iou_keys = ("" if iou_loss == "mse" else
                f"iou_loss={iou_loss}\niou_normalizer={iou_normalizer}\n"
                "cls_normalizer=1.0")
    # chmul scales every non-detection conv width (the CSP source stays
    # a multiple of groups=2 for any integer multiplier): the
    # accuracy-evidence sweeps widen the fixture so its 75%-pruned
    # REMNANT has capacity comparable to the v2 fixture's (the JAX
    # package's docs/PERF.md "YOLOv4-tiny iterative") without changing
    # the default tests
    c16, c20, c32, c40 = (16 * chmul, 20 * chmul, 32 * chmul, 40 * chmul)
    return f"""
[net]
batch=4
subdivisions=1
width={width}
height={height}
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
max_batches=500
policy=constant

[convolutional]
batch_normalize=1
filters={c16}
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters={c40}
size=3
stride=1
pad=1
activation=mish

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters={c20}
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters={c20}
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1,-2

[convolutional]
batch_normalize=1
filters={c40}
size=1
stride=1
pad=1
activation=leaky

[route]
layers=-6,-1

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters={c40}
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters={det}
activation=linear

[yolo]
mask = 2,3
anchors = 8,8,  16,16,  24,24,  48,48
classes={num_classes}
num=4
jitter=.3
ignore_thresh = .7
truth_thresh = 1
random=0
scale_x_y = 1.05
{iou_keys}

[route]
layers=-3

[convolutional]
batch_normalize=1
filters={c20}
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1,1

[convolutional]
batch_normalize=1
filters={c32}
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters={det}
activation=linear

[yolo]
mask = 0,1
anchors = 8,8,  16,16,  24,24,  48,48
classes={num_classes}
num=4
jitter=.3
ignore_thresh = .7
truth_thresh = 1
random=0
scale_x_y = 1.05
{iou_keys}
"""
