"""The plain fp32 forward of a Darknet detector, for the reference side.

NCHW, float32 with TF32 off, one layer at a time: conv (BN folded here
from the raw running statistics, or a bias), leaky 0.1 / mish / linear /
logistic, Darknet max pool, route, reorg, shortcut, nearest upsample.
Returns the inputs of the detection heads, in head order.

``lowp="fp8"`` is the control: the network computed in float8 e4m3
where the served path computes in bf16: each conv's input and weights,
its output and its activation's output rounded to fp8 (a scale per
tensor, per filter for the weights), the arithmetic between roundings
fp32. It stands for the precision a step below the served bf16.

``calibrate_bn`` sets the BN running statistics of raw seeded weights to
the statistics of a calibration batch, layer by layer, so that the folded
network stays in range at any depth.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0

Params = Dict[str, Dict[str, torch.Tensor]]


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fold(params: Params, layers: List[dict]) -> Params:
    out = {}
    for i, l in enumerate(layers):
        if l["type"] != "conv":
            continue
        p = params[f"conv{i}"]
        if l["bn"]:
            inv = p["gamma"].float() / torch.sqrt(p["var"].float() + BN_EPS)
            out[f"conv{i}"] = {
                "w": p["w"].float() * inv[:, None, None, None],
                "bias": p["beta"].float() - p["mean"].float() * inv}
        else:
            out[f"conv{i}"] = {"w": p["w"].float(),
                               "bias": p["bias"].float()}
    return out


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if kind == "mish":
        return x * torch.tanh(F.softplus(x))
    if kind == "linear":
        return x
    if kind == "logistic":
        return torch.sigmoid(x)
    raise ValueError(f"activation {kind!r}")


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def maxpool(x: torch.Tensor, l: dict) -> torch.Tensor:
    k, s, pt = l["size"], l["stride"], l["pad_total"]
    h, w = x.shape[2], x.shape[3]
    begin = pt // 2
    out_h = (h + pt - k) // s + 1
    out_w = (w + pt - k) // s + 1
    end_h = max(0, (out_h - 1) * s + k - h - begin)
    end_w = max(0, (out_w - 1) * s + k - w - begin)
    x = F.pad(x, (begin, end_w, begin, end_h), value=-math.inf)
    return F.max_pool2d(x, k, s)


def reorg(x: torch.Tensor, s: int) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, s * s * c, h // s, w // s)


def _walk(layers: List[dict], x_nchw: torch.Tensor, conv,
          after=lambda y: y) -> List[torch.Tensor]:
    """Run the layer graph; ``conv(i, layer, y)`` computes conv ``i``
    (with its BN or bias), ``after`` takes each activation's output.
    Returns the head inputs, NCHW."""
    outs: List[torch.Tensor] = []
    heads = []
    y = x_nchw.float()
    for i, l in enumerate(layers):
        t = l["type"]
        if t == "conv":
            y = after(activate(conv(i, l, y), l["act"]))
        elif t == "maxpool":
            y = maxpool(y, l)
        elif t == "route":
            parts = []
            for a in l["layers"]:
                src = outs[a]
                g = src.shape[1] // l["groups"]
                parts.append(src[:, l["group_id"] * g:(l["group_id"] + 1)
                                 * g] if l["groups"] > 1 else src)
            y = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        elif t == "reorg":
            y = reorg(y, l["stride"])
        elif t == "shortcut":
            y = activate(y + outs[l["src"]], l["act"])
        elif t == "upsample":
            s = l["stride"]
            y = y.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        elif t in ("yolo", "region"):
            heads.append(y)
        outs.append(y)
    return heads


@torch.no_grad()
def forward(folded: Params, layers: List[dict], x_nchw: torch.Tensor,
            lowp: Optional[str] = None) -> List[torch.Tensor]:
    """x (B, 3, H, W) float in [0, 1] -> head inputs, NCHW fp32."""
    if lowp not in (None, "fp8"):
        raise ValueError(f"lowp {lowp!r}")

    def q(t):
        return _fp8(t, (0, 1, 2, 3)) if lowp else t

    def conv(i, l, y):
        p = folded[f"conv{i}"]
        w = _fp8(p["w"], (1, 2, 3)) if lowp else p["w"]
        return q(F.conv2d(q(y), w, p["bias"], stride=l["stride"],
                          padding=l["pad"]))

    return _walk(layers, x_nchw, conv, after=q)


@torch.no_grad()
def calibrate_bn(params: Params, layers: List[dict],
                 x_nchw: torch.Tensor) -> None:
    """Write each BN conv's running mean and (biased) variance from the
    batch ``x`` flowing through the network as it is being calibrated."""

    def conv(i, l, y):
        p = params[f"conv{i}"]
        y = F.conv2d(y, p["w"].float(), None, stride=l["stride"],
                     padding=l["pad"])
        if not l["bn"]:
            return y + p["bias"][None, :, None, None]
        mu = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False)
        p["mean"].copy_(mu)
        p["var"].copy_(var)
        inv = p["gamma"] / torch.sqrt(var + BN_EPS)
        return (y - mu[None, :, None, None]) * inv[None, :, None, None] \
            + p["beta"][None, :, None, None]

    _walk(layers, x_nchw, conv)
