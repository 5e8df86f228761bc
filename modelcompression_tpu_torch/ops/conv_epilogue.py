"""Conv epilogue: the bias add and the activation after a BN-folded conv of
the bf16 forward, as one pass over the conv's output.

Two functions with one semantics, ``act(y + bias)`` per channel with the
arithmetic in fp32 and one rounding to y's dtype:

* ``bias_act_plain`` — plain PyTorch; the CPU tests and ``chip_smoke.py``
  compare the kernel with it.
* ``bias_act_cuda`` — the hand-written kernel ``csrc/conv_epilogue.cu``,
  in place on the conv's bf16 output in channels-last storage, every input
  checked. It replaces no TPU kernel: XLA fuses this epilogue for the JAX
  package.

``models/darknet.py``'s folded forward asks ``takes`` after each conv (the
bf16 card forward when no gradient is wanted) and then calls ``launch``,
the same launch without the checks ``takes`` has made.

Activations: ``linear``, ``leaky`` (slope 0.1) and ``mish``, computed as
``v * n / (n + 2)`` with ``n = e * (e + 2)``, ``e = exp(v)``, which is
``v * tanh(log1p(e))``, and as ``v`` itself above ``MISH_CUTOFF``, where
``tanh(softplus(v))`` is 1 in fp32.

The kernel launches through ``KERNEL`` (``ops/_build.Kernel``), which
counts its launches by output channels C and, under a recording profiler,
runs each inside a ``conv_epilogue`` host op.
"""

from __future__ import annotations

import ctypes

import torch

from modelcompression_tpu_torch.ops._build import Kernel

# the kernel's template parameter for each activation it takes
ACTIVATIONS = {"linear": 0, "leaky": 1, "mish": 2}
LEAKY_SLOPE = 0.1
MISH_CUTOFF = 20.0
# y, bias, y's elements, C, the activation
KERNEL = Kernel("conv_epilogue", (ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int))


def _check_kind(kind: str) -> None:
    if kind not in ACTIVATIONS:
        raise ValueError(f"conv epilogue takes {sorted(ACTIVATIONS)}, not "
                         f"{kind!r}")


def bias_act_plain(y: torch.Tensor, bias: torch.Tensor,
                   kind: str) -> torch.Tensor:
    """``act(y + bias)`` for NCHW ``y`` and ``bias`` (C,): y widened to
    fp32, the bias added in fp32, the activation in fp32, one rounding to
    y's dtype. Returns a new tensor."""
    _check_kind(kind)
    v = y.float() + bias.float()[None, :, None, None]
    if kind == "leaky":
        v = torch.where(v > 0, v, LEAKY_SLOPE * v)
    elif kind == "mish":
        e = torch.exp(torch.clamp(v, max=MISH_CUTOFF))
        n = e * (e + 2)
        v = torch.where(v > MISH_CUTOFF, v, v * n / (n + 2))
    return v.to(y.dtype)


def takes(y: torch.Tensor, kind: str) -> bool:
    """Whether a folded conv's output ``y`` takes the kernel in place of
    the eager bias add and activation: a plain bf16 CUDA (B, C, H, W)
    tensor in channels-last storage, an activation of ``ACTIVATIONS``, and
    no gradient wanted (the kernel writes in place, unseen by autograd).
    Everything else (the CPU, BITMATCH's fp32, autograd, the tensor
    subclasses of tracing) keeps the eager chain."""
    return (y.is_cuda and y.dtype == torch.bfloat16
            and type(y) is torch.Tensor and kind in ACTIVATIONS
            and y.dim() == 4
            and y.is_contiguous(memory_format=torch.channels_last)
            and not (torch.is_grad_enabled() and y.requires_grad))


def launch(y: torch.Tensor, bias: torch.Tensor, kind: str) -> torch.Tensor:
    """The kernel on PyTorch's current stream of y's device, y rewritten
    in place and returned, with no check of its inputs: y as ``takes``
    accepts it, bias its conv's fp32 (C,) contiguous bias on y's device.
    Raises when the launch is refused."""
    c = y.shape[1]
    KERNEL.launch(c, y.get_device(), y.data_ptr(), bias.data_ptr(),
                  y.numel(), c, ACTIVATIONS[kind])
    return y


def bias_act_cuda(y: torch.Tensor, bias: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """``launch`` after checking every input: y (B, C, H, W) bf16 on a
    CUDA device in channels-last storage (the conv's fresh output: nothing
    else may hold it); bias (C,) fp32, contiguous, on y's device; kind a
    key of ``ACTIVATIONS``. Raises on anything the kernel does not take."""
    _check_kind(kind)
    if y.dtype != torch.bfloat16:
        raise ValueError(f"conv epilogue kernel takes bf16 y, not {y.dtype}")
    if y.dim() != 4 or y.shape[1] < 1 \
            or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv epilogue kernel takes a (B, C, H, W) y in "
                         f"channels-last storage, got shape "
                         f"{tuple(y.shape)} strides {y.stride()}")
    c = y.shape[1]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (c,) \
            or not bias.is_contiguous() or bias.device != y.device:
        raise ValueError(f"conv epilogue kernel takes a contiguous fp32 "
                         f"({c},) bias on {y.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    if y.device.type != "cuda":
        raise ValueError(f"conv epilogue kernel needs a CUDA tensor, got "
                         f"{y.device}")
    return launch(y, bias, kind)
