"""Darknet-style network summary table, port of
``modelcompression_tpu/models/summary.py`` (its printed text is equal to
the JAX package's for the same cfg and weights).

``network_table(spec)`` renders one row per layer with the spatial/channel
walk, per-conv params and MAC*2 FLOPs (the same conventions as
``darknet.num_conv_flops``), plus totals. With ``params`` given it also
reports each conv's nonzero-weight fraction: the per-layer sparsity view
that audits masked checkpoints (repacked models show 100% dense at
smaller shapes). Host metadata only: no device.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, MaxPoolLayer, NetworkSpec, RegionLayer, ReorgLayer,
    RouteLayer, ShortcutLayer, UpsampleLayer, YoloLayer,
)
from modelcompression_tpu_torch.models.darknet import Params, conv_key


def _fmt_count(n: int) -> str:
    if n >= 1e9:
        return f"{n / 1e9:.2f}G"
    if n >= 1e6:
        return f"{n / 1e6:.2f}M"
    if n >= 1e3:
        return f"{n / 1e3:.1f}k"
    return str(n)


def layer_shapes(spec: NetworkSpec) -> List[tuple]:
    """Per-layer output (h, w, c), with the forward's exact spatial
    conventions: conv (h + 2*pad - size)//stride + 1; Darknet maxpool
    (h + pad_total - size)//stride + 1 (pad_total honors an explicit
    cfg padding= knob; the size-1 default gives (h-1)//stride + 1, NOT
    h//stride — differs for odd dims and the
    Tiny-YOLOv2 stride-1 final pool); reorg h//stride with
    channels*stride²; route concatenates channels at the first source's
    spatial dims. The ONE spatial walk — reused by the summary table and
    the FLOPs-weighted tools."""
    h, w = spec.net.height, spec.net.width
    c = spec.net.channels
    hwc: List[tuple] = []
    for l in spec.layers:
        if isinstance(l, ConvLayer):
            h = (h + 2 * l.padding - l.size) // l.stride + 1
            w = (w + 2 * l.padding - l.size) // l.stride + 1
            c = l.filters
        elif isinstance(l, MaxPoolLayer):
            h = (h + l.pad_total - l.size) // l.stride + 1
            w = (w + l.pad_total - l.size) // l.stride + 1
        elif isinstance(l, RouteLayer):
            h, w, _ = hwc[l.layers[0]]
            c = sum(hwc[a][2] // l.groups for a in l.layers)
        elif isinstance(l, ReorgLayer):
            h, w = h // l.stride, w // l.stride
            c = c * l.stride * l.stride
        elif isinstance(l, UpsampleLayer):
            h, w = h * l.stride, w * l.stride
        # shortcut/yolo/region: pass-through shapes
        hwc.append((h, w, c))
    return hwc


def network_table(spec: NetworkSpec,
                  params: Optional[Params] = None) -> str:
    """One text table for the whole network; see module docstring.
    Spatial dims come from ``layer_shapes`` (the forward's conventions).
    """
    shapes = layer_shapes(spec)
    lines = []
    have_sparsity = params is not None
    head = (f"{'idx':>4} {'layer':<7} {'filters':>7} {'size/str':>9} "
            f"{'input':>16} {'output':>16} {'params':>8} {'FLOPs':>8}")
    if have_sparsity:
        head += f" {'nonzero':>8}"
    lines.append(head)
    total_params = 0
    total_flops = 0
    total_nonzero = 0
    for i, l in enumerate(spec.layers):
        in_h, in_w, in_c = shapes[i - 1] if i else (
            spec.net.height, spec.net.width, spec.net.channels)
        h, w, c = shapes[i]
        if isinstance(l, ConvLayer):
            n_w = l.size * l.size * l.in_channels * l.filters
            n_aux = l.filters * (4 if l.batch_normalize else 1)
            flops = 2 * h * w * l.size * l.size * l.in_channels * l.filters
            total_params += n_w + n_aux
            total_flops += flops
            row = (f"{i:>4} {'conv':<7} {l.filters:>7} "
                   f"{l.size:>4}x{l.size}/{l.stride:<2} "
                   f"{in_w:>5}x{in_h}x{in_c:<4} {w:>5}x{h}x{c:<4} "
                   f"{_fmt_count(n_w + n_aux):>8} {_fmt_count(flops):>8}")
            if have_sparsity:
                wv = params[conv_key(i)]["w"]
                nz = int(torch.count_nonzero(wv))
                total_nonzero += nz + n_aux
                row += f" {nz / max(wv.numel(), 1):>7.1%}"
            lines.append(row)
        elif isinstance(l, MaxPoolLayer):
            lines.append(
                f"{i:>4} {'max':<7} {'':>7} "
                f"{l.size:>4}x{l.size}/{l.stride:<2} "
                f"{in_w:>5}x{in_h}x{in_c:<4} {w:>5}x{h}x{c:<4}")
        elif isinstance(l, RouteLayer):
            srcs = ",".join(str(a) for a in l.layers)
            lines.append(
                f"{i:>4} {'route':<7} {srcs:>7} {'':>9} {'':>16} "
                f"{w:>5}x{h}x{c:<4}")
        elif isinstance(l, ReorgLayer):
            lines.append(
                f"{i:>4} {'reorg':<7} {'':>7} {'/' + str(l.stride):>9} "
                f"{in_w:>5}x{in_h}x{in_c:<4} {w:>5}x{h}x{c:<4}")
        elif isinstance(l, ShortcutLayer):
            lines.append(
                f"{i:>4} {'short':<7} {l.from_layer:>7} {'':>9} {'':>16} "
                f"{w:>5}x{h}x{c:<4}")
        elif isinstance(l, UpsampleLayer):
            lines.append(
                f"{i:>4} {'upsamp':<7} {'':>7} {'x' + str(l.stride):>9} "
                f"{in_w:>5}x{in_h}x{in_c:<4} {w:>5}x{h}x{c:<4}")
        elif isinstance(l, YoloLayer):
            lines.append(
                f"{i:>4} {'yolo':<7} {l.n:>4}x{5 + l.classes}"
                f" mask={','.join(str(m) for m in l.mask)}"
                f" classes={l.classes}")
        elif isinstance(l, RegionLayer):
            lines.append(
                f"{i:>4} {'region':<7} {l.num:>4}x{1 + l.coords + l.classes}"
                f" anchors={len(l.anchors) // 2} classes={l.classes}")
    foot = (f"total: {_fmt_count(total_params)} params, "
            f"{_fmt_count(total_flops)} FLOPs/img "
            f"@ {spec.net.width}x{spec.net.height}")
    if have_sparsity and total_params:
        foot += (f", {total_nonzero / total_params:.1%} nonzero "
                 f"({_fmt_count(total_nonzero)})")
    lines.append(foot)
    return "\n".join(lines)
