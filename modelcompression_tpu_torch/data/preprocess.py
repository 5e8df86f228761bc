"""Eval-side image preprocessing (port of the serving subset of
``modelcompression_tpu/data/preprocess.py``).

* ``letterbox_device`` — aspect-preserving resize + gray padding on the
  tensor's device, the resize as two interpolation matmuls.
* ``stretch_resize_device`` — plain stretch resize to the net size.
* ``normalize`` — uint8 -> float /255 (Darknet's only normalization).
* ``letterbox_host`` — cv2 letterbox for variable-size images, producing
  the same uint8 canvas. An image already at the size it is resized to
  is copied without cv2 (``cv2.resize`` to the same size returns the
  input unchanged); any other size imports cv2 when called.

Images are NHWC ``(B, H, W, 3)``, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.data.voc import import_cv2

GRAY = 127  # Darknet letterbox padding value (0.5 in float)


def normalize(images_uint8: torch.Tensor) -> torch.Tensor:
    return images_uint8.to(torch.float32) / 255.0


def _linear_resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation matrix, half-pixel centers, no
    antialias — the cv2.INTER_LINEAR / Darknet convention."""
    out = np.zeros((dst, src), np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        out[i, min(max(x0, 0), src - 1)] += 1.0 - f
        out[i, min(max(x0 + 1, 0), src - 1)] += f
    return out


@functools.lru_cache(maxsize=32)
def _resize_matrix_on(src: int, dst: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """``_linear_resize_matrix`` built once per (shape, dtype, device): a
    serving step would otherwise rebuild it in a Python loop and copy it
    from pageable host memory on every batch (which also makes the host
    wait for the device). Callers must not write to it."""
    return torch.from_numpy(_linear_resize_matrix(src, dst)).to(
        device=device, dtype=dtype)


def _bilinear_resize_nchw(t: torch.Tensor, new_h: int,
                          new_w: int) -> torch.Tensor:
    """Separable bilinear resize of NCHW ``t`` as two matmuls in t's dtype
    (a bf16 input runs the whole resize in bf16)."""
    h, w = t.shape[2], t.shape[3]
    if (h, w) == (new_h, new_w):
        return t
    wh = _resize_matrix_on(h, new_h, t.dtype, t.device)       # (new_h, h)
    ww = _resize_matrix_on(w, new_w, t.dtype, t.device)       # (new_w, w)
    return torch.matmul(torch.matmul(wh, t), ww.t())


def _bilinear_resize(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Separable bilinear resize of NHWC ``x`` (B, H, W, C) as two matmuls,
    matching cv2.INTER_LINEAR sampling; returns NHWC."""
    t = _bilinear_resize_nchw(x.permute(0, 3, 1, 2), new_h, new_w)
    return t.permute(0, 2, 3, 1)


def _to_float(images: torch.Tensor, dtype) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return images.to(dtype) / 255.0
    return images.to(dtype)


def letterbox_device(images: torch.Tensor, net_h: int, net_w: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Aspect-preserving resize + center pad on the images' device.

    images: (B, H, W, 3) uint8 (scaled /255) or float. ``dtype`` is the
    compute and output dtype: fp32 is the bit-faithful default, the FAST
    eval pipeline passes bf16. Returns a contiguous (B, net_h, net_w, 3)
    canvas in [0, 1]."""
    b, h, w, c = images.shape
    r = min(net_w / w, net_h / h)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    t = _bilinear_resize_nchw(_to_float(images, dtype).permute(0, 3, 1, 2),
                              new_h, new_w)
    pad_top = (net_h - new_h) // 2
    pad_left = (net_w - new_w) // 2
    t = F.pad(t, (pad_left, net_w - new_w - pad_left,
                  pad_top, net_h - new_h - pad_top),
              value=GRAY / 255.0)  # same canvas value as letterbox_host
    return t.permute(0, 2, 3, 1).contiguous()


def stretch_resize_device(images: torch.Tensor, net_h: int, net_w: int,
                          dtype=torch.float32) -> torch.Tensor:
    """Plain stretch resize to the net size; ``dtype`` as in
    ``letterbox_device``. Returns a contiguous NHWC canvas."""
    t = _bilinear_resize_nchw(_to_float(images, dtype).permute(0, 3, 1, 2),
                              net_h, net_w)
    return t.permute(0, 2, 3, 1).contiguous()


def resize_host(image: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """``cv2.resize`` INTER_LINEAR, or a copy when the size is unchanged
    (what cv2 returns then), so same-size images need no cv2."""
    if image.shape[:2] == (new_h, new_w):
        return image.copy()
    cv2 = import_cv2(f"resizing a {image.shape[1]}x{image.shape[0]} image "
                     f"to {new_w}x{new_h}")
    return cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_LINEAR)


def letterbox_host(image: np.ndarray, net_h: int, net_w: int
                   ) -> Tuple[np.ndarray, float, int, int]:
    """Host letterbox for variable-size images.

    Returns (canvas uint8 (net_h, net_w, 3), scale r, pad_left, pad_top).
    """
    h, w = image.shape[:2]
    r = min(net_w / w, net_h / h)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    resized = resize_host(image, new_w, new_h)
    canvas = np.full((net_h, net_w, 3), GRAY, np.uint8)
    pad_top = (net_h - new_h) // 2
    pad_left = (net_w - new_w) // 2
    canvas[pad_top:pad_top + new_h, pad_left:pad_left + new_w] = resized
    return canvas, r, pad_left, pad_top
