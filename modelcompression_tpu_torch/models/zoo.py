"""Bundled model architectures, read from the port's own ``configs/``
(a copy of ``modelcompression_tpu/configs``): the YOLOv2, YOLOv3 and
YOLOv4 families of ``modelcompression_tpu/models/zoo.py``, same names."""

from __future__ import annotations

import os

from modelcompression_tpu_torch.models.cfg import NetworkSpec, load_cfg

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "configs")


def cfg_path(name: str) -> str:
    return os.path.join(CONFIG_DIR, name)


def yolov2_voc() -> NetworkSpec:
    return load_cfg(cfg_path("yolov2-voc.cfg"))


def tiny_yolov2_voc() -> NetworkSpec:
    return load_cfg(cfg_path("tiny-yolo-voc.cfg"))


def yolov2_coco() -> NetworkSpec:
    """Full YOLOv2 with the 80-class COCO head and the public COCO anchor
    priors (the darknet yolov2.cfg shape)."""
    return load_cfg(cfg_path("yolov2-coco.cfg"))


def tiny_yolov2_coco() -> NetworkSpec:
    return load_cfg(cfg_path("tiny-yolo-coco.cfg"))


def yolov3_coco() -> NetworkSpec:
    """Full YOLOv3 (Darknet-53 + 3-scale FPN head, 80 classes)."""
    return load_cfg(cfg_path("yolov3.cfg"))


def yolov3_voc() -> NetworkSpec:
    return load_cfg(cfg_path("yolov3-voc.cfg"))


def yolov3_spp_coco() -> NetworkSpec:
    """YOLOv3-SPP (public darknet yolov3-spp.cfg): YOLOv3 with a spatial
    pyramid pooling block — three stride-1 maxpools (5/9/13) over the
    13x13x512 head map, 4-way route concat (2048ch), 1x1 bottleneck —
    inserted after the third head conv."""
    return load_cfg(cfg_path("yolov3-spp.cfg"))


def yolov3_tiny_coco() -> NetworkSpec:
    return load_cfg(cfg_path("yolov3-tiny.cfg"))


def yolov3_tiny_voc() -> NetworkSpec:
    return load_cfg(cfg_path("yolov3-tiny-voc.cfg"))


def yolov4_coco() -> NetworkSpec:
    """Full YOLOv4 (Bochkovskiy et al. 2020; public AlexeyAB yolov4.cfg
    shape): CSPDarknet53 backbone (route-back CSP stages, 1/2/8/8/4
    residual blocks, mish) + SPP + PANet head (leaky), three [yolo]
    heads with scale_x_y 1.2/1.1/1.05 and the canonical CIoU training
    keys. 64.43M params / 128.39 conv-GFLOP at 608."""
    return load_cfg(cfg_path("yolov4.cfg"))


def yolov4_voc() -> NetworkSpec:
    """Full YOLOv4 with the 20-class VOC head at 416 input (det convs
    75ch; 64.11M params / 59.67 conv-GFLOP)."""
    return load_cfg(cfg_path("yolov4-voc.cfg"))


def yolov4_tiny_coco() -> NetworkSpec:
    """yolov4-tiny (public AlexeyAB/darknet cfg shape): CSPOSANet
    backbone — grouped [route] splits (groups=2, group_id=1), two
    scale_x_y=1.05 [yolo] heads. 6.06M params / 6.91 GFLOP at 416."""
    return load_cfg(cfg_path("yolov4-tiny.cfg"))


def yolov4_tiny_voc() -> NetworkSpec:
    """yolov4-tiny with the 20-class VOC head (det convs 75ch)."""
    return load_cfg(cfg_path("yolov4-tiny-voc.cfg"))


def coco_names_path() -> str:
    return cfg_path("coco.names")


def voc_names_path() -> str:
    return cfg_path("voc.names")
