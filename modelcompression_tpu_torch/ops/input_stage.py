"""Fused input stage: conv1 (3x3, stride 1, pad 1, C_in=3) + bias + leaky
+ maxpool (2x2, stride 2) as one op.

Port of ``modelcompression_tpu/ops/input_stage.py``. Three functions with
one semantics, and their dispatcher:

* ``fused_conv1_pool_plain`` — plain PyTorch, the port of the JAX twin
  ``fused_conv1_pool_xla``: one matmul over the space-to-depth grid
  (K = 9 taps x 12 s2d channels = 108, N = 4*C phase columns), then a max
  over the four pool phases, bias and leaky in fp32.
* ``fused_conv1_pool_mma`` — the bf16 route's hand-written Hopper kernel
  ``csrc/input_stage_mma.cu``, on the tensor cores (``mma.sync``) in the
  direct GEMM form: rows (pooled pixel, phase), K = the 27 taps padded to
  32 (``pack_mma_weights``), N = C. Replaces the TPU kernel ``_kernel`` of
  the JAX module on the serving path.
* ``fused_conv1_pool_f32`` — the fp32 (BITMATCH) route's hand-written
  Hopper kernel ``csrc/input_stage_f32.cu`` on the CUDA cores: taps
  outside and pool phases inside, 8 channels per thread, persistent blocks
  with a ``cp.async`` double-buffered halo.
* ``fused_conv1_pool`` — the dispatcher: the plain version for CPU
  tensors; for CUDA tensors the mma kernel in bf16 and the fp32 kernel in
  fp32 (never a fallback between them).

The kernels launch through ``MMA`` and ``F32`` (``ops/_build.Kernel``),
which count their launches by output channels C.

Exactness: maxpool(leaky(conv(x) + b)) == leaky(max_phases(conv) + b),
since leaky is monotone increasing and b is constant per channel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, MaxPoolLayer, NetworkSpec, RouteLayer,
)
from modelcompression_tpu_torch.ops._build import Kernel

# pool phase (py, px) order; phase p lives in output columns [p*C, (p+1)*C)
_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
LEAKY_SLOPE = 0.1
MAX_FILTERS = 32  # the kernel's register width; the gate's 4*C <= 128


def input_stage_match(spec: NetworkSpec) -> bool:
    """True iff layers[0:2] are the fusable conv+pool pattern and no route
    consumes the un-pooled conv output."""
    if len(spec.layers) < 2:
        return False
    if spec.net.height % 2 or spec.net.width % 2:
        return False
    l0, l1 = spec.layers[0], spec.layers[1]
    if not (isinstance(l0, ConvLayer) and l0.size == 3 and l0.stride == 1
            and l0.padding == 1 and l0.in_channels == 3
            and l0.activation == "leaky" and 4 * l0.filters <= 128):
        return False
    if not (isinstance(l1, MaxPoolLayer) and l1.size == 2 and l1.stride == 2
            and l1.pad_total // 2 == 0):
        return False
    for l in spec.layers:
        if isinstance(l, RouteLayer) and 0 in l.layers:
            return False
    return True


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel j = (ry*2 + rx)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


@functools.lru_cache(maxsize=None)
def _tap_matrix() -> np.ndarray:
    """(108, 4, 3, 3, 3) 0/1 tensor M[k, p, ky, kx, c] mapping conv taps to
    patch lanes: lane k = (dy*3 + dx)*12 + (ry*2 + rx)*3 + c reads the
    padded-s2d value s2d[y+dy-1, x+dx-1, (ry*2+rx)*3 + c]; phase p=(py, px)
    tap (ky, kx, c) reads pixel (2y+py+ky-1, 2x+px+kx-1, c), i.e.
    ry = (py+ky+1) % 2 and dy = (py+ky-1-ry)//2 + 1 (same for x)."""
    m = np.zeros((108, 4, 3, 3, 3), np.float32)
    for p, (py, px) in enumerate(_PHASES):
        for ky in range(3):
            ry = (py + ky + 1) % 2
            dy = (py + ky - 1 - ry) // 2 + 1
            for kx in range(3):
                rx = (px + kx + 1) % 2
                dx = (px + kx - 1 - rx) // 2 + 1
                for c in range(3):
                    k = (dy * 3 + dx) * 12 + (ry * 2 + rx) * 3 + c
                    m[k, p, ky, kx, c] = 1.0
    return m


def s2d_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """(C, 3, 3, 3) OIHW conv kernel -> (108, 4C) phase-matmul weights.
    Every entry is a copy of one weight or 0, so this is exact."""
    c_out = w_oihw.shape[0]
    m = torch.as_tensor(_tap_matrix(), device=w_oihw.device)
    w_hwio = w_oihw.float().permute(2, 3, 1, 0)
    ws = torch.einsum("kpyxc,yxcf->kpf", m, w_hwio)
    return ws.reshape(108, 4 * c_out).to(w_oihw.dtype)


def fused_conv1_pool_plain(x: torch.Tensor, w_oihw: torch.Tensor,
                           bias: torch.Tensor,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version (materializes the im2col patches).

    x: (B, H, W, 3) float, H/W even; w (C, 3, 3, 3) OIHW; bias (C,).
    Operands are rounded to ``compute_dtype``, products summed in fp32
    (bf16 x bf16 products are exact in fp32, so fp32 matmul on the rounded
    operands is bf16-in/fp32-accumulate), bias + leaky in fp32, one
    rounding to ``compute_dtype``. Returns (B, H/2, W/2, C)."""
    b, h, w, _ = x.shape
    h2, w2 = h // 2, w // 2
    s = space_to_depth2(x.to(compute_dtype))
    sp = F.pad(s, (0, 0, 1, 1, 1, 1))               # (B, H2+2, W2+2, 12)
    patches = torch.cat([sp[:, dy:dy + h2, dx:dx + w2, :]
                         for dy in range(3) for dx in range(3)], dim=-1)
    ws = s2d_weights(w_oihw.to(compute_dtype))      # (108, 4C)
    r = torch.matmul(patches.float(), ws.float())  # (B, H2, W2, 4C) fp32
    c_out = w_oihw.shape[0]
    r = r.reshape(b, h2, w2, 4, c_out).amax(dim=3)
    y = r + bias.float()
    y = torch.where(y > 0, y, LEAKY_SLOPE * y)
    return y.to(compute_dtype)


MMA_TAPS = 32  # K of the mma kernel: the 27 taps padded to two k16 steps


def pack_mma_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """(C, 3, 3, 3) OIHW -> (N_pad, 32) in w's dtype (the kernel takes
    bf16), N_pad = C rounded up to a multiple of 8: row n holds output
    channel n's taps at k = (ky*3 + kx)*3 + ci, zero for k >= 27 and for
    n >= C."""
    c_out = w_oihw.shape[0]
    n_pad = -(-c_out // 8) * 8
    wk = w_oihw.permute(0, 2, 3, 1).reshape(c_out, 27)
    return F.pad(wk, (0, MMA_TAPS - 27, 0, n_pad - c_out)).contiguous()


def _check_args(x: torch.Tensor, w_oihw: torch.Tensor,
                bias: torch.Tensor) -> None:
    """Raise on shapes the input-stage kernels do not take, then on a
    tensor that is not on a CUDA device."""
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"x must be (B, H, W, 3), got {tuple(x.shape)}")
    h, w = x.shape[1], x.shape[2]
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got {h}x{w}")
    c_out = w_oihw.shape[0]
    if tuple(w_oihw.shape) != (c_out, 3, 3, 3) or not 1 <= c_out <= \
            MAX_FILTERS:
        raise ValueError(f"w must be (C, 3, 3, 3) with C <= {MAX_FILTERS}, "
                         f"got {tuple(w_oihw.shape)}")
    if tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias must be ({c_out},), got {tuple(bias.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"input-stage kernel needs a CUDA tensor, got "
                         f"{x.device}")


# x, the kernel's weights, bias (fp32), the output, then B, H, W, C
_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
MMA = Kernel("input_stage_mma", _ARGS)
F32 = Kernel("input_stage_f32", _ARGS)


def _launch(kernel: Kernel, x: torch.Tensor, wk: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """``kernel`` on x, the kernel's weights ``wk`` and bias (cast to
    fp32) into a fresh (B, H/2, W/2, C) output in x's dtype, returned."""
    b, h, w, _ = x.shape
    c_out = bias.shape[0]
    x = x.contiguous()
    bk = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, h // 2, w // 2, c_out), dtype=x.dtype,
                      device=x.device)
    kernel.launch(c_out, x.get_device(), x.data_ptr(), wk.data_ptr(),
                  bk.data_ptr(), out.data_ptr(), b, h, w, c_out)
    return out


def fused_conv1_pool_mma(x: torch.Tensor, w_oihw: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/input_stage_mma.cu`` on PyTorch's current stream.

    x (B, H, W, 3) bf16 on a CUDA device, H and W even; w (C, 3, 3, 3)
    OIHW with C <= 32 (rounded to bf16 and packed by ``pack_mma_weights``);
    bias (C,) (fp32 in the kernel). Returns (B, H/2, W/2, C) bf16. Raises
    on anything the kernel does not take, and when the launch is
    refused."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the mma input-stage kernel takes bf16 x, not "
                         f"{x.dtype}")
    _check_args(x, w_oihw, bias)
    wp = pack_mma_weights(w_oihw.to(device=x.device, dtype=torch.bfloat16))
    return _launch(MMA, x, wp, bias)


def fused_conv1_pool_f32(x: torch.Tensor, w_oihw: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/input_stage_f32.cu`` on PyTorch's current stream.

    x (B, H, W, 3) fp32 on a CUDA device, H and W even; w (C, 3, 3, 3)
    OIHW with C <= 32 (fp32 in the kernel); bias (C,) (fp32 in the
    kernel). Returns (B, H/2, W/2, C) fp32. Raises on anything the kernel
    does not take, and when the launch is refused."""
    if x.dtype != torch.float32:
        raise ValueError(f"the fp32 input-stage kernel takes fp32 x, not "
                         f"{x.dtype}")
    _check_args(x, w_oihw, bias)
    wk = w_oihw.to(device=x.device, dtype=torch.float32).contiguous()
    return _launch(F32, x, wk, bias)


def fused_conv1_pool(x: torch.Tensor, w_oihw: torch.Tensor,
                     bias: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Dispatcher: the plain version only for CPU tensors; for CUDA
    tensors a kernel launches or raises: bf16 on the tensor cores
    (``fused_conv1_pool_mma``), fp32 on the CUDA cores
    (``fused_conv1_pool_f32``); any other dtype raises."""
    if x.device.type == "cuda":
        if compute_dtype == torch.bfloat16:
            return fused_conv1_pool_mma(x.to(compute_dtype), w_oihw, bias)
        if compute_dtype == torch.float32:
            return fused_conv1_pool_f32(x.to(compute_dtype), w_oihw, bias)
        raise ValueError(f"input-stage kernels take bf16 or fp32, not "
                         f"{compute_dtype}")
    if x.device.type == "cpu":
        return fused_conv1_pool_plain(x, w_oihw, bias, compute_dtype)
    raise ValueError(f"fused_conv1_pool: unsupported device {x.device}")
