"""Image preprocessing, port of ``modelcompression_tpu/data/preprocess.py``.

* ``letterbox_device`` — aspect-preserving resize + gray padding on the
  tensor's device, the resize as two interpolation matmuls.
* ``stretch_resize_device`` — plain stretch resize to the net size.
* ``normalize`` — uint8 -> float /255 (Darknet's only normalization).
* ``quantize_canvas`` — a [0, 1] canvas on the int8 network-input grid;
  the two device resizes emit it with ``quant_scale``.
* ``letterbox_host`` — cv2 letterbox for variable-size images, producing
  the same uint8 canvas. An image already at the size it is resized to
  is copied without cv2 (``cv2.resize`` to the same size returns the
  input unchanged); any other size imports cv2 when called.
* The train augment: ``random_flip``, ``random_jitter``, ``mosaic4`` and
  ``distort_hsv`` on the batch's device. Each is split into a ``sample_*``
  draw from an explicit ``torch.Generator`` (on the CPU, whatever the
  images' device, so a seed gives the same draws on every device) and an
  ``apply_*`` function of the drawn values; the JAX package's random
  streams cannot be matched, its draws can be passed in.

Images are NHWC ``(B, H, W, 3)``, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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


def quantize_canvas(x: torch.Tensor, quant_scale) -> torch.Tensor:
    """[0, 1] float canvas -> int8 on the network-input grid
    (``quant_scale``: the calibrated input step, a float or a 0-dim
    tensor). The rounding runs in fp32, exactly as
    ``compress/quantize.forward_quantized`` quantizes its input, so an
    int8 canvas is bit-equal to the float canvas followed by the
    forward's own quantize."""
    s = torch.as_tensor(quant_scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / s),
                       -127, 127).to(torch.int8)


def letterbox_device(images: torch.Tensor, net_h: int, net_w: int,
                     dtype=torch.float32, quant_scale=None) -> torch.Tensor:
    """Aspect-preserving resize + center pad on the images' device.

    images: (B, H, W, 3) uint8 (scaled /255) or float. ``dtype`` is the
    compute and output dtype: fp32 is the bit-faithful default, the FAST
    eval pipeline passes bf16. With ``quant_scale`` the resized canvas is
    quantized (``quantize_canvas``) and the gray padding goes on the int8
    grid, quantized from its fp32 value as the JAX package does. Returns
    a contiguous (B, net_h, net_w, 3) canvas in [0, 1], or int8 with
    ``quant_scale``."""
    b, h, w, c = images.shape
    r = min(net_w / w, net_h / h)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    t = _bilinear_resize_nchw(_to_float(images, dtype).permute(0, 3, 1, 2),
                              new_h, new_w)
    pad_top = (net_h - new_h) // 2
    pad_left = (net_w - new_w) // 2
    if quant_scale is None:
        t = F.pad(t, (pad_left, net_w - new_w - pad_left,
                      pad_top, net_h - new_h - pad_top),
                  value=GRAY / 255.0)  # same canvas value as letterbox_host
        return t.permute(0, 2, 3, 1).contiguous()
    # the int8 gray from a device tensor: no host read of the scale
    gray = quantize_canvas(torch.tensor(GRAY / 255.0, dtype=torch.float32,
                                        device=t.device), quant_scale)
    out = torch.empty((b, net_h, net_w, c), dtype=torch.int8,
                      device=t.device)
    out.copy_(gray)
    out[:, pad_top:pad_top + new_h, pad_left:pad_left + new_w] = \
        quantize_canvas(t, quant_scale).permute(0, 2, 3, 1)
    return out


def stretch_resize_device(images: torch.Tensor, net_h: int, net_w: int,
                          dtype=torch.float32,
                          quant_scale=None) -> torch.Tensor:
    """Plain stretch resize to the net size; ``dtype`` and ``quant_scale``
    as in ``letterbox_device``. Returns a contiguous NHWC canvas."""
    t = _bilinear_resize_nchw(_to_float(images, dtype).permute(0, 3, 1, 2),
                              net_h, net_w)
    t = t.permute(0, 2, 3, 1).contiguous()
    return t if quant_scale is None else quantize_canvas(t, quant_scale)


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


# ---- train augment ----------------------------------------------------------

def _uniform(n: int, lo: float, hi: float,
             gen: torch.Generator) -> torch.Tensor:
    """(n,) float32 draws in [lo, hi) from ``gen`` (on the CPU)."""
    return torch.rand(n, generator=gen) * (hi - lo) + lo


def _on(v: torch.Tensor, device: torch.device, dtype=None) -> torch.Tensor:
    """A drawn value on the images' device. To CUDA it goes from pinned
    memory without blocking: a blocking copy from host memory makes the
    host wait for all the device work queued before it."""
    v = v if dtype is None else v.to(dtype)
    if v.device == device:
        return v
    if device.type == "cuda" and v.device.type == "cpu":
        return v.pin_memory().to(device, non_blocking=True)
    return v.to(device)


def sample_flip(b: int, gen: torch.Generator) -> torch.Tensor:
    """(b,) bool: flip each sample with p=0.5."""
    return torch.rand(b, generator=gen) < 0.5


def apply_flip(images: torch.Tensor, boxes: torch.Tensor,
               flip: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal flip of the samples where ``flip``; boxes (B, M, 5)
    [cls, cx, cy, w, h] get cx -> 1 - cx (invalid rows, w <= 0, keep
    theirs). Works on uint8 images too (a permutation and a select)."""
    flip = _on(flip, images.device)
    images = torch.where(flip[:, None, None, None],
                         torch.flip(images, dims=[2]), images)
    cx = torch.where(flip[:, None], 1.0 - boxes[..., 1], boxes[..., 1])
    cx = torch.where(boxes[..., 3] > 0, cx, boxes[..., 1])
    return images, torch.cat([boxes[..., :1], cx[..., None], boxes[..., 2:]],
                             dim=-1)


def random_flip(images: torch.Tensor, boxes: torch.Tensor,
                gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    return apply_flip(images, boxes, sample_flip(images.shape[0], gen))


def _st_weights(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """Per-sample (B, in, out) weights of ``jax.image.scale_and_translate``
    with ``method='linear', antialias=False``: the triangle kernel at
    sample = (o + 0.5)/s - t/s - 0.5, each output's weights divided by
    their sum (so an edge replicates rather than darkens), and outputs
    whose sample falls outside [-0.5, in - 0.5] set to zero. ``scale`` and
    ``translation`` are (B,) float32. This is not ``F.grid_sample``, whose
    border modes neither renormalize nor zero that way."""
    dev = scale.device
    inv = 1.0 / scale[:, None]
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev)
               + 0.5) * inv - translation[:, None] * inv - 0.5)  # (B, out)
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = torch.abs(sample[:, None, :] - src[None, :, None])      # (B, in, out)
    weights = torch.clamp_min(1 - x, 0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def _scale_and_translate(images: torch.Tensor, sy: torch.Tensor,
                         sx: torch.Tensor, ty: torch.Tensor,
                         tx: torch.Tensor) -> torch.Tensor:
    """Per-sample resample of NHWC float ``images`` at the same size: rows
    by (sy, ty), columns by (sx, tx), as two batched matmuls."""
    b, h, w, c = images.shape
    wy = _st_weights(h, h, sy, ty).to(images.dtype)  # (B, in_h, out_h)
    wx = _st_weights(w, w, sx, tx).to(images.dtype)  # (B, in_w, out_w)
    t = images.permute(0, 3, 1, 2).reshape(b, c * h, w)
    t = torch.bmm(t, wx).reshape(b, c, h, w)          # columns
    t = torch.matmul(wy.transpose(1, 2)[:, None], t)  # rows
    return t.permute(0, 2, 3, 1)


def sample_jitter(b: int, gen: torch.Generator, jitter: float = 0.2
                  ) -> Tuple[torch.Tensor, ...]:
    """(pl, pr, pt, pb), each (b,) ~ U(-jitter, jitter): how far each edge
    of the crop window moves, as a fraction of the image."""
    if not 0.0 <= jitter < 0.5:
        # two opposing edges each move by up to `jitter`, so >= 0.5 lets
        # the crop window collapse to zero or negative size
        raise ValueError(f"jitter must be in [0, 0.5), got {jitter}")
    return tuple(_uniform(b, -jitter, jitter, gen) for _ in range(4))


def apply_jitter(images: torch.Tensor, boxes: torch.Tensor,
                 pl: torch.Tensor, pr: torch.Tensor, pt: torch.Tensor,
                 pb: torch.Tensor, min_box: float = 0.01
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Darknet-style crop/stretch jitter with the drawn edge offsets: the
    window [pl, 1 - pr] x [pt, 1 - pb] is resampled to the full frame,
    outside the source filled with GRAY. Boxes are remapped; a box whose
    center leaves the frame or whose clipped size drops to ``min_box`` or
    below becomes an invalid (zero) row. images float (B, H, W, 3)."""
    b, h, w, _ = images.shape
    dev = images.device
    pl, pr, pt, pb = (_on(v, dev, torch.float32) for v in (pl, pr, pt, pb))
    sw = 1.0 - pl - pr   # crop window size, fraction of the full width
    sh = 1.0 - pt - pb
    # output coord o maps to input coord o*s + p (normalized): for
    # scale_and_translate, in = (o - t)/scale, so scale = 1/s, t = -p/s
    scale_y, scale_x = 1.0 / sh, 1.0 / sw
    trans_y, trans_x = -pt * h / sh, -pl * w / sw
    out = _scale_and_translate(images, scale_y, scale_x, trans_y, trans_x)
    yy = (torch.arange(h, device=dev)[None, :] - trans_y[:, None]) \
        / scale_y[:, None]
    xx = (torch.arange(w, device=dev)[None, :] - trans_x[:, None]) \
        / scale_x[:, None]
    inside = ((yy >= -0.5) & (yy <= h - 0.5))[:, :, None] \
        & ((xx >= -0.5) & (xx <= w - 0.5))[:, None, :]
    images = torch.where(inside[..., None], out, GRAY / 255.0)

    valid = boxes[..., 3] > 0
    cx = (boxes[..., 1] - pl[:, None]) / sw[:, None]
    cy = (boxes[..., 2] - pt[:, None]) / sh[:, None]
    bw = boxes[..., 3] / sw[:, None]
    bh = boxes[..., 4] / sh[:, None]
    # clip the extents to the frame, recompute center and size
    x1 = torch.clamp(cx - bw / 2, 0.0, 1.0)
    x2 = torch.clamp(cx + bw / 2, 0.0, 1.0)
    y1 = torch.clamp(cy - bh / 2, 0.0, 1.0)
    y2 = torch.clamp(cy + bh / 2, 0.0, 1.0)
    bw, bh = x2 - x1, y2 - y1
    keep = valid & (bw > min_box) & (bh > min_box) \
        & (cx > 0) & (cx < 1) & (cy > 0) & (cy < 1)
    out_boxes = torch.stack([boxes[..., 0], (x1 + x2) / 2, (y1 + y2) / 2,
                             bw, bh], dim=-1)
    return images, torch.where(keep[..., None], out_boxes, 0.0)


def random_jitter(images: torch.Tensor, boxes: torch.Tensor,
                  gen: torch.Generator, jitter: float = 0.2,
                  min_box: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return apply_jitter(images, boxes,
                        *sample_jitter(images.shape[0], gen, jitter),
                        min_box=min_box)


_QUADRANTS = ((0, 0), (0, 1), (1, 0), (1, 1))


def sample_mosaic_center(b: int, gen: torch.Generator,
                         center_range: Tuple[float, float] = (0.3, 0.7)
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fy, fx), each (b,) ~ U(center_range): the mosaic's split point."""
    lo, hi = center_range
    if not 0.0 < lo <= hi < 1.0:
        raise ValueError(f"center_range must satisfy 0 < lo <= hi < 1, "
                         f"got {center_range}")
    fy = _uniform(b, lo, hi, gen)
    return fy, _uniform(b, lo, hi, gen)


def _mosaic_boxes(boxes, k, qh, qw, oy, ox):
    """Quadrant k's boxes: source sample (i + k) mod B, scaled by the
    quadrant size (qh, qw) and shifted to its origin (oy, ox); invalid
    rows stay zero."""
    bx = torch.roll(boxes, -k, dims=0)
    scaled = torch.stack([bx[..., 0], bx[..., 1] * qw + ox,
                          bx[..., 2] * qh + oy, bx[..., 3] * qw,
                          bx[..., 4] * qh], -1)
    return torch.where(bx[..., 3:4] > 0, scaled, 0.0)


def apply_mosaic4(images: torch.Tensor, boxes: torch.Tensor,
                  fy: Optional[torch.Tensor] = None,
                  fx: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """4-image mosaic: sample i with samples (i+1, i+2, i+3) mod B in a
    2x2 grid split at (fy, fx), each source squashed to fill its quadrant.
    ``fy = fx = None`` is the fixed midpoint (half-size resize by the two
    cv2-convention matmuls, then concatenation).

    images (B, H, W, 3) float, H and W even; boxes (B, M, 5). Returns
    (B, H, W, 3) images and (B, 4*M, 5) boxes."""
    b, h, w, c = images.shape
    if fy is None:
        half = _bilinear_resize(images, h // 2, w // 2)
        tiles = [torch.roll(half, -k, dims=0) for k in range(4)]
        parts = [_mosaic_boxes(boxes, k, 0.5, 0.5, 0.5 * r_, 0.5 * c_)
                 for k, (r_, c_) in enumerate(_QUADRANTS)]
        top = torch.cat(tiles[:2], dim=2)
        bot = torch.cat(tiles[2:], dim=2)
        return torch.cat([top, bot], dim=1), torch.cat(parts, dim=1)

    dev = images.device
    fy = _on(fy, dev, torch.float32)
    fx = _on(fx, dev, torch.float32)
    ys = torch.arange(h, device=dev)[None, :, None, None]
    xs = torch.arange(w, device=dev)[None, None, :, None]
    fy_b = fy[:, None, None, None]
    fx_b = fx[:, None, None, None]
    out = torch.zeros_like(images)
    parts = []
    for k, (r_, c_) in enumerate(_QUADRANTS):
        src = torch.roll(images, -k, dims=0)  # one copy live at a time
        qh = (1.0 - fy) if r_ else fy         # quadrant size, normalized
        qw = (1.0 - fx) if c_ else fx
        ty = fy * h if r_ else torch.zeros_like(fy)  # quadrant origin, px
        tx = fx * w if c_ else torch.zeros_like(fx)
        tile = _scale_and_translate(src, qh, qw, ty, tx)
        in_y = (ys < fy_b * h) if r_ == 0 else (ys >= fy_b * h)
        in_x = (xs < fx_b * w) if c_ == 0 else (xs >= fx_b * w)
        out = torch.where(in_y & in_x, tile, out)
        parts.append(_mosaic_boxes(
            boxes, k, qh[:, None], qw[:, None],
            (fy if r_ else torch.zeros_like(fy))[:, None],
            (fx if c_ else torch.zeros_like(fx))[:, None]))
    return out, torch.cat(parts, dim=1)


def mosaic4(images: torch.Tensor, boxes: torch.Tensor,
            gen: Optional[torch.Generator],
            center_range: Optional[Tuple[float, float]] = (0.3, 0.7)
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_mosaic4`` at a split point drawn per sample from
    ``center_range``; ``center_range=None`` is the fixed midpoint (no
    draw)."""
    if center_range is None:
        return apply_mosaic4(images, boxes)
    return apply_mosaic4(images, boxes, *sample_mosaic_center(
        images.shape[0], gen, center_range))


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Elementwise RGB [0,1] -> HSV with H in [0,1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.amax(dim=-1)
    lo = rgb.amin(dim=-1)
    c = v - lo
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c,
                                4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Elementwise HSV (H in [0,1)) -> RGB [0,1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):  # vals[k] where i == k
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def sample_hsv(b: int, gen: torch.Generator, hue: float = 0.1,
               sat: float = 1.5, expo: float = 1.5
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_sat, d_exp, d_hue), each (b, 1, 1): S scale ~ U(1/sat, sat), V
    scale ~ U(1/expo, expo), H shift ~ U(-hue, hue)."""
    d_sat = _uniform(b, 1.0 / sat, sat, gen)
    d_exp = _uniform(b, 1.0 / expo, expo, gen)
    d_hue = _uniform(b, -hue, hue, gen)
    return tuple(d[:, None, None] for d in (d_sat, d_exp, d_hue))


def apply_distort_hsv(images: torch.Tensor, d_sat: torch.Tensor,
                      d_exp: torch.Tensor, d_hue: torch.Tensor
                      ) -> torch.Tensor:
    """Darknet's random_distort_image with the drawn factors: to HSV, S
    and V scaled (clipped to [0,1]), H shifted with wraparound, back to
    RGB. images float [0,1] (B, H, W, 3)."""
    dev = images.device
    d_sat, d_exp, d_hue = (_on(d, dev, torch.float32)
                           for d in (d_sat, d_exp, d_hue))
    hsv = rgb_to_hsv(torch.clamp(images, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + d_hue, 1.0)
    s = torch.clamp(hsv[..., 1] * d_sat, 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * d_exp, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def distort_hsv(images: torch.Tensor, gen: torch.Generator,
                hue: float = 0.1, sat: float = 1.5, expo: float = 1.5
                ) -> torch.Tensor:
    return apply_distort_hsv(images, *sample_hsv(images.shape[0], gen,
                                                 hue, sat, expo))
