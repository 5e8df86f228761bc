"""The int8 x int8 -> int32 convolution of the quantized forward
(``compress/quantize.forward_quantized``).

The JAX package computes it with XLA's
``jax.lax.conv_general_dilated(q_in, w_q, ..., preferred_element_type=
jnp.int32)`` (``modelcompression_tpu/compress/quantize.py:358``), not with
a Pallas kernel, so the card may take a library integer GEMM here, as
the JAX package left the product to XLA:

* ``int8_conv_plain`` (the CPU route and the reference): a float64
  convolution, cast back to int32. It is exact: a sum has at most
  3 x 3 x 1280 = 11,520 taps of |a·w| <= 127², below 2^31 < 2^53, so
  every partial sum is an integer float64 holds exactly, in any order.
* ``int8_conv_cuda`` (the card route): ``torch._int_mm`` (cuBLASLt's
  int8 GEMM, int32 accumulation) over the NHWC activations. A 1x1
  stride-1 conv needs no im2col: its rows are the pixels. Any other conv
  builds one im2col in (kh, kw, C) order, the order HWIO weights flatten
  in, and runs one GEMM over it. The im2col is chosen over nine shifted
  GEMMs: a shifted NHWC window is not a matrix either, so each of the
  nine would copy its input anyway, and each would write and re-read an
  int32 partial sum; the im2col copies once and gives the GEMM the whole
  depth kh·kw·C at once. ``_int_mm`` needs more than 16 rows and a
  depth and width that are multiples of 8: the wrapper pads the depth
  (YOLOv2's conv1: 27 taps -> 32) and the width (YOLOv2's 125-channel
  head -> 128, YOLOv4's 75 -> 80) with zeros, pads too few rows with
  zero rows, and slices the result. A shape or dtype ``_int_mm`` then
  still refuses raises; nothing falls back to the plain version or to a
  float conv.

Each card-route call adds one to ``int8_conv_cuda.LAUNCHES``, and to
``int8_conv_cuda.LAUNCHES_AT`` under its output channels. These are not
entries of ``ops.KERNELS``, which lists the hand-written ``csrc/``
kernels. ``int8_conv`` sends CPU tensors to the plain version and CUDA
tensors to the card route, never one in place of the other.

Layouts are the JAX package's: activations NHWC ``(B, H, W, C)`` int8,
weights HWIO ``(kh, kw, C, N)`` int8, output NHWC int32.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

MIN_ROWS = 17  # _int_mm takes more than 16 rows
ALIGN = 8      # _int_mm's depth and width are multiples of 8


def _check(x_q: torch.Tensor, w_q: torch.Tensor) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8 conv takes int8 activations and weights, "
                         f"got {x_q.dtype} and {w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"int8 conv takes NHWC activations and HWIO "
                         f"weights, got shapes {tuple(x_q.shape)} and "
                         f"{tuple(w_q.shape)}")
    if x_q.shape[3] != w_q.shape[2]:
        raise ValueError(f"activations have {x_q.shape[3]} channels, the "
                         f"weights take {w_q.shape[2]}")
    if x_q.device != w_q.device:
        raise ValueError(f"activations on {x_q.device}, weights on "
                         f"{w_q.device}")


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                    padding: int) -> torch.Tensor:
    """NHWC int8 ``x_q`` convolved with HWIO int8 ``w_q`` (zero padding
    ``padding`` on each side, ``stride``): the exact int32 sums, NHWC, by
    a float64 convolution."""
    _check(x_q, w_q)
    x = x_q.permute(0, 3, 1, 2).to(torch.float64)
    w = w_q.permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x, w, stride=stride, padding=padding)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _im2col(x_q: torch.Tensor, kh: int, kw: int, stride: int,
            padding: int, k_pad: int):
    """(B·Ho·Wo, k_pad) int8 rows in (kh, kw, C) order, zero past kh·kw·C;
    returns (rows, Ho, Wo)."""
    b, h, w, c = x_q.shape
    if padding:
        x_q = F.pad(x_q, (0, 0, padding, padding, padding, padding))
    # (B, Ho, Wo, C, kh, kw) views of the padded NHWC input
    win = x_q.unfold(1, kh, stride).unfold(2, kw, stride)
    ho, wo = win.shape[1], win.shape[2]
    k = kh * kw * c
    rows = (x_q.new_zeros((b * ho * wo, k_pad)) if k_pad != k
            else x_q.new_empty((b * ho * wo, k)))
    rows[:, :k].view(b, ho, wo, kh, kw, c).copy_(win.permute(0, 1, 2, 4,
                                                            5, 3))
    return rows, ho, wo


def int8_gemm_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                   padding: int) -> torch.Tensor:
    """The card route's arithmetic on any device: ``torch._int_mm`` over
    the NHWC rows (an im2col unless the conv is 1x1 at stride 1), depth,
    width and rows padded to what it takes. Returns the int32 sums NHWC
    ``(B, Ho, Wo, N)``. ``int8_conv_cuda`` runs it on the card; the CPU
    tests run it on the CPU's ``_int_mm`` to hold its layout."""
    _check(x_q, w_q)
    kh, kw, c, n = w_q.shape
    b, h, w, _ = x_q.shape
    k = kh * kw * c
    k_pad, n_pad = _round_up(k, ALIGN), _round_up(n, ALIGN)
    if kh == kw == 1 and stride == 1 and padding == 0 and k == k_pad:
        rows, ho, wo = x_q.contiguous().view(b * h * w, c), h, w
    else:
        rows, ho, wo = _im2col(x_q, kh, kw, stride, padding, k_pad)
    m = rows.shape[0]
    if m < MIN_ROWS:
        rows = torch.cat([rows, rows.new_zeros((MIN_ROWS - m, k_pad))])
    # B as cuBLASLt's int8 GEMM takes it: an (N, K) row-major matrix,
    # transposed, so both operands run along K
    wt = w_q.new_zeros((n_pad, k_pad))
    wt[:n, :k] = w_q.reshape(k, n).t()
    return torch._int_mm(rows, wt.t())[:m, :n].view(b, ho, wo, n)


def int8_conv_cuda(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                   padding: int) -> torch.Tensor:
    """The card route (``int8_gemm_conv`` on a CUDA device), counted in
    ``LAUNCHES``; raises on a tensor that is not on a CUDA device."""
    if x_q.device.type != "cuda":
        raise ValueError(f"the int8 conv's card route needs CUDA tensors, "
                         f"got {x_q.device}")
    y = int8_gemm_conv(x_q, w_q, stride, padding)
    int8_conv_cuda.LAUNCHES += 1
    int8_conv_cuda.LAUNCHES_AT[w_q.shape[3]] += 1
    return y


int8_conv_cuda.LAUNCHES = 0
int8_conv_cuda.LAUNCHES_AT = collections.Counter()  # by output channels


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
              padding: int) -> torch.Tensor:
    """The int8 conv on the activations' device: the card route for a
    CUDA tensor, the plain version for a CPU one."""
    if x_q.device.type == "cuda":
        return int8_conv_cuda(x_q, w_q, stride, padding)
    if x_q.device.type == "cpu":
        return int8_conv_plain(x_q, w_q, stride, padding)
    raise ValueError(f"unsupported device {x_q.device}")
