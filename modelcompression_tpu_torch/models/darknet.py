"""Darknet/YOLOv2 forward pass in PyTorch.

Port of ``modelcompression_tpu/models/darknet.py``. Layout:

* Public functions keep the JAX package's layouts: images in are NHWC
  ``(B, H, W, 3)`` floats in [0, 1], raw maps out are NHWC
  ``(B, H/32, W/32, A*(5+C))`` fp32.
* Conv weights are held OIHW (Darknet's ``.weights`` order, so the codec
  needs no transpose); per-conv state lives under the JAX keys
  (``conv{i}`` -> ``w`` plus ``bias`` or ``gamma/beta/mean/var``).
* Inside, the conv stack runs NCHW in ``torch.channels_last``: an NHWC
  tensor permuted to NCHW is already channels-last storage, so the input
  stage kernel's ``(B, H/2, W/2, C)`` output feeds conv 2 with no copy.
* The BN-folded forward in bf16 on the card, when no gradient is wanted,
  runs each conv's bias add and activation as one hand-written pass in
  place on the conv's output (``ops/conv_epilogue.py``); every other
  forward (CPU, BITMATCH, autograd) keeps the eager chain.

Darknet quirks carried over: maxpool size-2/stride-1 pads bottom/right
with -inf; ``reorg`` is TF ``space_to_depth`` order (channel-major over
the 2x2 subpixel), which is NOT ``torch.pixel_unshuffle`` order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.core.precision import BITMATCH, Precision
from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, MaxPoolLayer, NetworkSpec, RegionLayer, ReorgLayer, RouteLayer,
    ShortcutLayer, UpsampleLayer, YoloLayer,
)

# torch.nn.BatchNorm2d default, as in the JAX package
BN_EPS = 1e-5

Params = Dict[str, Dict[str, torch.Tensor]]


def conv_key(layer_idx: int) -> str:
    return f"conv{layer_idx}"


def init_params(spec: NetworkSpec, seed: int = 0,
                dtype=torch.float32, device="cpu") -> Params:
    """He-init conv weights (OIHW) from a ``torch.Generator`` seeded with
    ``seed``; BN gamma=1, beta=0, mean=0, var=1. The draws differ from the
    JAX package's for the same seed (different generators)."""
    gen = torch.Generator().manual_seed(seed)
    params: Params = {}
    for i, l in enumerate(spec.layers):
        if not isinstance(l, ConvLayer):
            continue
        std = math.sqrt(2.0 / (l.in_channels * l.size * l.size))
        w = torch.randn((l.filters, l.in_channels, l.size, l.size),
                        generator=gen, dtype=dtype) * std
        p = {"w": w}
        if l.batch_normalize:
            p["gamma"] = torch.ones(l.filters, dtype=dtype)
            p["beta"] = torch.zeros(l.filters, dtype=dtype)
            p["mean"] = torch.zeros(l.filters, dtype=dtype)
            p["var"] = torch.ones(l.filters, dtype=dtype)
        else:
            p["bias"] = torch.zeros(l.filters, dtype=dtype)
        params[conv_key(i)] = {k: v.to(device) for k, v in p.items()}
    return params


def params_to(params: Params, device) -> Params:
    return {k: {n: v.to(device) for n, v in p.items()}
            for k, p in params.items()}


def _activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "leaky":
        return F.leaky_relu(x, 0.1)
    if kind == "linear":
        return x
    if kind == "relu":
        return torch.relu(x)
    if kind == "logistic":
        return torch.sigmoid(x)
    if kind == "mish":
        return x * torch.tanh(F.softplus(x))
    raise ValueError(f"unsupported activation {kind!r}")


def _per_channel(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype)[None, :, None, None]


def _conv(x: torch.Tensor, w: torch.Tensor, layer: ConvLayer,
          precision: Precision) -> torch.Tensor:
    """x NCHW (channels-last storage), w OIHW; output in compute dtype."""
    w = precision.cast_in(w).contiguous(memory_format=torch.channels_last)
    return F.conv2d(precision.cast_in(x), w, stride=layer.stride,
                    padding=layer.padding)


def conv_bn_act(x: torch.Tensor, p: Dict[str, torch.Tensor],
                layer: ConvLayer, precision: Precision,
                train_stats: bool = False) -> torch.Tensor:
    """Conv + (BN | bias) + activation, unfolded BN. BN uses the running
    statistics, or with ``train_stats`` the batch's own, as the JAX
    package's two-pass ``jnp.mean`` / ``jnp.var`` in y's dtype."""
    y = _conv(x, p["w"], layer, precision)
    if layer.batch_normalize:
        if train_stats:
            mu = y.mean(dim=(0, 2, 3))
            var = (y - mu[None, :, None, None]).square().mean(dim=(0, 2, 3))
        else:
            mu = p["mean"].to(y.dtype)
            var = p["var"].to(y.dtype)
        # the rsqrt at least in fp32: bf16 widens, float64 stays float64
        inv = torch.rsqrt(var.to(torch.promote_types(var.dtype,
                                                     torch.float32))
                          + BN_EPS).to(y.dtype)
        y = (y - mu[None, :, None, None]) \
            * _per_channel(p["gamma"].to(y.dtype) * inv, y.dtype) \
            + _per_channel(p["beta"], y.dtype)
    else:
        y = y + _per_channel(p["bias"], y.dtype)
    return _activate(y, layer.activation)


def route_part(t: torch.Tensor, layer: RouteLayer) -> torch.Tensor:
    """One route source's contribution (NCHW): the full tensor, or its CSP
    group slice along channels."""
    if layer.groups == 1:
        return t
    g = t.shape[1] // layer.groups
    return t[:, layer.group_id * g:(layer.group_id + 1) * g]


def maxpool(x: torch.Tensor, layer: MaxPoolLayer) -> torch.Tensor:
    """Darknet maxpool on NCHW: out = (in + pad_total - size)//stride + 1,
    window origin offset by -pad_total//2, out-of-bounds reads -inf (so a
    size-2/stride-1 pool pads one row/column at the bottom/right).

    An integer tensor (the int8 activations of
    ``compress/quantize.forward_quantized``) pads with its dtype's minimum,
    as the JAX package does, and pools exactly in a float dtype that holds
    its values (int8: fp16 on the card; fp32 otherwise); it comes back in
    its own dtype."""
    k, s = layer.size, layer.stride
    h, w = x.shape[2], x.shape[3]
    pad_total = layer.pad_total
    pad_begin = pad_total // 2
    out_h = (h + pad_total - k) // s + 1
    out_w = (w + pad_total - k) // s + 1
    pad_h_end = max(0, (out_h - 1) * s + k - h - pad_begin)
    pad_w_end = max(0, (out_w - 1) * s + k - w - pad_begin)
    dtype = x.dtype
    if dtype.is_floating_point:
        pad_value = -math.inf
    else:
        pad_value = torch.iinfo(dtype).min
        # fp16 holds every 8-bit integer exactly
        x = x.to(torch.float16 if x.is_cuda and x.element_size() == 1
                 else torch.float32)
    if pad_begin or pad_h_end or pad_w_end:
        x = F.pad(x, (pad_begin, pad_w_end, pad_begin, pad_h_end),
                  value=pad_value)
    return F.max_pool2d(x, kernel_size=k, stride=s).to(dtype)


def reorg(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Darknet passthrough/reorg on NCHW with the JAX package's (TF
    ``space_to_depth``) channel order:

        out[b, (s*hi + wi)*C + c, i, j] = x[b, c, s*i + hi, s*j + wi]

    ``torch.pixel_unshuffle`` orders channels c-major instead."""
    b, c, h, w = x.shape
    s = stride
    x = x.reshape(b, c, h // s, s, w // s, s)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, s * s * c, h // s, w // s)


def upsample_nearest(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Darknet [upsample] on NCHW: out[i, j] = in[i // s, j // s], written
    in channels-last storage as the rest of the conv stack (repeated on
    the NHWC view)."""
    x = x.permute(0, 2, 3, 1)
    x = x.repeat_interleave(stride, dim=1).repeat_interleave(stride, dim=2)
    return x.permute(0, 3, 1, 2)


def _nhwc_out(y: torch.Tensor) -> torch.Tensor:
    """A raw map out: NHWC, float32 (or wider, as given)."""
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    return y.permute(0, 2, 3, 1)


def _forward_impl(params: Params, x: torch.Tensor, spec: NetworkSpec,
                  precision: Precision, folded: bool, channel_masks,
                  fuse_input_stage: bool = False, train_stats: bool = False):
    precision.apply_backend_flags()
    if folded:
        from modelcompression_tpu_torch.ops import conv_epilogue
    outputs: List[Optional[torch.Tensor]] = []
    heads: List[torch.Tensor] = []
    start = 0
    if fuse_input_stage:
        # conv1 + bias + leaky + 2x2 maxpool as one hand-written kernel
        # (ops/input_stage.py). The caller has checked input_stage_match;
        # the fusion needs the folded (bias) form of conv 0.
        if not folded:
            raise ValueError("fuse_input_stage requires BN-folded params")
        from modelcompression_tpu_torch.ops.input_stage import (
            fused_conv1_pool,
        )
        p0 = params[conv_key(0)]
        y = fused_conv1_pool(x, p0["w"], p0["bias"],
                             compute_dtype=precision.compute_dtype)
        y = y.permute(0, 3, 1, 2)  # NHWC storage == channels-last NCHW
        if channel_masks is not None and 0 in channel_masks:
            y = y * _per_channel(channel_masks[0], y.dtype)
        # layer 0's un-pooled output is never materialized (no route
        # consumes it: input_stage_match guarantees this)
        outputs.append(None)
        outputs.append(y)
        start = 2
    else:
        y = precision.cast_in(x).permute(0, 3, 1, 2)
    for i in range(start, len(spec.layers)):
        l = spec.layers[i]
        if isinstance(l, ConvLayer):
            p = params[conv_key(i)]
            if folded:
                y = _conv(y, p["w"], l, precision)
                if conv_epilogue.takes(y, l.activation):
                    # bias + activation in one hand-written pass, in place
                    y = conv_epilogue.launch(y, p["bias"].float(),
                                             l.activation)
                else:
                    y = _activate(y + _per_channel(p["bias"], y.dtype),
                                  l.activation)
            else:
                y = conv_bn_act(y, p, l, precision, train_stats=train_stats)
            if channel_masks is not None and i in channel_masks:
                # post-activation channel mask: the masked twin of a
                # structurally repacked model (compress/repack.py)
                y = y * _per_channel(channel_masks[i], y.dtype)
        elif isinstance(l, MaxPoolLayer):
            y = maxpool(y, l)
        elif isinstance(l, RouteLayer):
            parts = [route_part(outputs[a], l) for a in l.layers]
            y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        elif isinstance(l, ReorgLayer):
            y = reorg(y, l.stride)
        elif isinstance(l, ShortcutLayer):
            y = _activate(y + outputs[l.from_layer], l.activation)
        elif isinstance(l, UpsampleLayer):
            y = upsample_nearest(y, l.stride)
        elif isinstance(l, YoloLayer):
            heads.append(_nhwc_out(y))
        elif isinstance(l, RegionLayer):
            pass  # decode handled by evaluation.decode on the raw map
        outputs.append(y)
    if heads:
        return tuple(heads)
    return _nhwc_out(y)


def forward(params: Params, x: torch.Tensor, spec: NetworkSpec,
            precision: Precision = BITMATCH, train_stats: bool = False,
            channel_masks=None):
    """Run the network on NHWC ``x``; returns the NHWC raw map (or a tuple
    of per-head maps for [yolo] specs). BN uses the running statistics,
    or the batch's own with ``train_stats`` (the train step has its own
    one-pass form, ``train/train_step.py``). ``channel_masks``: optional
    ``{layer_idx: (C,) 0/1 tensor}`` applied post-activation."""
    return _forward_impl(params, x, spec, precision, folded=False,
                         channel_masks=channel_masks,
                         train_stats=train_stats)


def fold_batchnorm(params: Params, spec: NetworkSpec) -> Params:
    """w' = w * gamma/sqrt(var+eps); b' = beta - mean*gamma/sqrt(var+eps)."""
    folded: Params = {}
    for i, l in enumerate(spec.layers):
        if not isinstance(l, ConvLayer):
            continue
        p = params[conv_key(i)]
        if l.batch_normalize:
            inv = p["gamma"] / torch.sqrt(p["var"] + BN_EPS)
            folded[conv_key(i)] = {
                "w": p["w"] * inv[:, None, None, None],
                "bias": p["beta"] - p["mean"] * inv,
            }
        else:
            folded[conv_key(i)] = dict(p)
    return folded


def forward_folded(params: Params, x: torch.Tensor, spec: NetworkSpec,
                   precision: Precision, channel_masks=None,
                   fuse_input_stage: bool = False):
    """Forward for BN-folded params. ``fuse_input_stage`` runs conv1+pool
    through ``ops.input_stage.fused_conv1_pool`` (valid only when
    ``input_stage_match(spec)``)."""
    return _forward_impl(params, x, spec, precision, folded=True,
                         channel_masks=channel_masks,
                         fuse_input_stage=fuse_input_stage)


def num_params(params: Params) -> int:
    return sum(int(v.numel()) for p in params.values() for v in p.values())


def num_conv_flops(spec: NetworkSpec) -> int:
    """Conv MAC*2 FLOPs for one image at the spec's input size."""
    flops = 0
    hw: List[tuple] = []
    h, w = spec.net.height, spec.net.width
    for l in spec.layers:
        if isinstance(l, ConvLayer):
            h = (h + 2 * l.padding - l.size) // l.stride + 1
            w = (w + 2 * l.padding - l.size) // l.stride + 1
            flops += 2 * h * w * l.size * l.size * l.in_channels * l.filters
        elif isinstance(l, MaxPoolLayer):
            h = (h + l.pad_total - l.size) // l.stride + 1
            w = (w + l.pad_total - l.size) // l.stride + 1
        elif isinstance(l, ReorgLayer):
            h, w = h // l.stride, w // l.stride
        elif isinstance(l, UpsampleLayer):
            h, w = h * l.stride, w * l.stride
        elif isinstance(l, RouteLayer):
            h, w = hw[l.layers[0]]
        hw.append((h, w))
    return flops
