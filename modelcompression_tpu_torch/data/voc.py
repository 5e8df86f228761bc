"""Pascal VOC (and Darknet-txt) dataset loading, port of
``modelcompression_tpu/data/voc.py``.

Two on-disk formats:

* **Darknet list format**: a ``.data`` file pointing at train/valid list
  files of image paths; per-image labels in a sibling ``labels/`` dir as
  ``<stem>.txt`` with rows ``class cx cy w h`` (normalized); class names
  from a ``.names`` file.
* **VOC devkit XML**: ``Annotations/*.xml`` + ``JPEGImages``, parsed with
  the stdlib ElementTree, honouring the ``difficult`` flag (the mAP
  protocol ignores difficult objects).

Image decode: ``.png`` goes through the port's own codec
(``data/png.py``), so 8-bit gray/RGB/RGBA PNG datasets load without cv2;
PNG is lossless, so the pixels equal ``cv2.imread``'s. The PNG kinds that
codec does not decode (palette, gray+alpha, 16-bit, interlaced) and every
other format (VOC's JPEG) go to cv2, imported when an image is read, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

import numpy as np

from modelcompression_tpu_torch.data.png import UnsupportedPNG, read_png

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def import_cv2(what: str):
    """cv2, or an ImportError that names it and what needed it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} needs cv2 (opencv-python), which is not installed; "
            "without it the port decodes only 8-bit gray/RGB/RGBA .png "
            "images and letterboxes only images already at the network "
            "size") from e
    return cv2


@dataclasses.dataclass
class Sample:
    image_path: str
    image_id: str
    # (M, 5) float32 rows [cls, cx, cy, w, h], normalized; empty -> (0, 5)
    labels: np.ndarray
    difficult: Optional[np.ndarray] = None  # (M,) bool, XML datasets only

    def load_image(self) -> np.ndarray:
        """(H, W, 3) uint8 RGB, as ``cv2.imread(IMREAD_COLOR)`` then BGR ->
        RGB: gray is replicated, alpha dropped."""
        what = f"decoding {self.image_path}"
        if self.image_path.lower().endswith(".png"):
            if not os.path.exists(self.image_path):
                raise FileNotFoundError(self.image_path)
            try:
                img = read_png(self.image_path)
            except UnsupportedPNG as e:
                found = str(e).removeprefix(f"{self.image_path}: ")
                what = f"{what} ({found})"
            else:
                if img.ndim == 2:
                    return np.repeat(img[:, :, None], 3, axis=2)
                return np.ascontiguousarray(img[:, :, :3])
        cv2 = import_cv2(what)
        img = cv2.imread(self.image_path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(self.image_path)
        return img[:, :, ::-1]  # BGR -> RGB


def read_names(path: str) -> List[str]:
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def read_data_cfg(path: str) -> dict:
    """Parse a Darknet ``.data`` file (train=..., valid=..., names=...)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _label_path(image_path: str) -> str:
    """Darknet convention: .../images/foo.jpg -> .../labels/foo.txt (also
    JPEGImages -> labels); falls back to a sibling .txt.

    Only a whole path component named images/JPEGImages is rewritten (the
    nearest one to the file), and only if the rewritten label file exists:
    a substring replace would corrupt paths like .../my_images_v2/..., and
    an unconditional return would defeat the sibling fallback.
    """
    d, fname = os.path.split(image_path)
    stem = os.path.splitext(fname)[0]
    parts = d.split(os.sep)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] in ("images", "JPEGImages"):
            cand = os.sep.join(parts[:i] + ["labels"] + parts[i + 1:]
                               + [stem + ".txt"])
            if os.path.exists(cand):
                return cand
            break
    return os.path.join(d, stem + ".txt")


def load_list_dataset(list_file: str) -> List[Sample]:
    samples = []
    root = os.path.dirname(os.path.abspath(list_file))
    with open(list_file) as f:
        for line in f:
            p = line.strip()
            if not p:
                continue
            if not os.path.isabs(p):
                p = os.path.join(root, p)
            lp = _label_path(p)
            if os.path.exists(lp):
                arr = np.loadtxt(lp, dtype=np.float32, ndmin=2)
                labels = arr.reshape(-1, 5) if arr.size else \
                    np.zeros((0, 5), np.float32)
            else:
                labels = np.zeros((0, 5), np.float32)
            samples.append(Sample(
                image_path=p,
                image_id=os.path.splitext(os.path.basename(p))[0],
                labels=labels))
    return samples


def parse_voc_xml(xml_path: str, class_names: Sequence[str] = VOC_CLASSES
                  ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Returns (labels (M,5) normalized, difficult (M,), (width, height))."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = int(size.find("width").text)
    h = int(size.find("height").text)
    rows, diff = [], []
    for obj in root.iter("object"):
        name = obj.find("name").text.strip()
        if name not in class_names:
            continue
        cls = class_names.index(name)
        d = obj.find("difficult")
        difficult = bool(int(d.text)) if d is not None else False
        bb = obj.find("bndbox")
        # VOC boxes are 1-based inclusive pixel coords
        x1 = float(bb.find("xmin").text) - 1
        y1 = float(bb.find("ymin").text) - 1
        x2 = float(bb.find("xmax").text) - 1
        y2 = float(bb.find("ymax").text) - 1
        rows.append([cls, (x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                     (x2 - x1) / w, (y2 - y1) / h])
        diff.append(difficult)
    labels = np.asarray(rows, np.float32).reshape(-1, 5)
    return labels, np.asarray(diff, bool), (w, h)


def load_voc_devkit(voc_root: str, image_set: str = "test",
                    year: str = "2007",
                    class_names: Sequence[str] = VOC_CLASSES
                    ) -> List[Sample]:
    """Load a VOCdevkit split: VOCdevkit/VOC<year>/ImageSets/Main/<set>.txt."""
    vdir = os.path.join(voc_root, f"VOC{year}")
    ids_file = os.path.join(vdir, "ImageSets", "Main", f"{image_set}.txt")
    with open(ids_file) as f:
        # main split files hold one id per line; per-class files (e.g.
        # 'aeroplane_test') hold 'id flag' pairs: take the id token
        ids = [l.split()[0] for l in f if l.strip()]
    samples = []
    missing = 0
    for img_id in ids:
        xml = os.path.join(vdir, "Annotations", f"{img_id}.xml")
        if os.path.exists(xml):
            labels, difficult, _ = parse_voc_xml(xml, class_names)
        else:
            missing += 1
            labels = np.zeros((0, 5), np.float32)
            difficult = np.zeros((0,), bool)
        samples.append(Sample(
            image_path=os.path.join(vdir, "JPEGImages", f"{img_id}.jpg"),
            image_id=img_id, labels=labels, difficult=difficult))
    if missing == len(samples) and samples:
        # the annotations archive ships apart from the images; evaluating
        # against zero ground truth would silently corrupt the mAP
        raise FileNotFoundError(
            f"no annotation XML found for ANY of the {len(samples)} ids in "
            f"{ids_file} (looked in {os.path.join(vdir, 'Annotations')}) — "
            "is the VOC annotations archive extracted?")
    if missing:
        print(f"[warn] {missing}/{len(samples)} ids have no annotation XML "
              f"(treated as zero-object images)", file=sys.stderr)
    return samples


def pad_labels(labels: np.ndarray, max_boxes: int) -> np.ndarray:
    """Pad/truncate (M,5) to (max_boxes,5); padding rows are all-zero
    (w == 0 marks invalid)."""
    out = np.zeros((max_boxes, 5), np.float32)
    m = min(len(labels), max_boxes)
    out[:m] = labels[:m]
    return out
