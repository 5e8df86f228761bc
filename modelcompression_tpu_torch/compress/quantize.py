"""Post-training int8 quantization, port of
``modelcompression_tpu/compress/quantize.py``.

The scheme is the JAX package's (its module docstring):

* **Weights**: per-output-channel symmetric int8 (``s_w[c] =
  max|w[..., c]| / 127``, floored at 1e-12), quantized from the BN-folded
  weights.
* **Activations**: per-tensor symmetric int8 with static scales from a
  calibration pass; int8 flows between layers, and each int8 conv runs

      y32 = conv(x_q, w_q)                  # int8 x int8 -> int32
      y   = y32 * (s_in * s_w[c]) + bias    # fp32, in this order
      out = clip(round(act(y) / s_out), -127, 127)

  Head producers skip the requantize and return the raw fp32 map.
* **Scale groups**: maxpool, reorg, upsample and the heads pass int8
  through on their producer's grid; a route's inputs share one scale, so
  the int8 concat is exact; a shortcut is a float boundary with its own
  scale.
* **Hybrid** (``int8_layers=``): the other convs keep fp32 weights and
  run in the precision's compute dtype; the forward (de)quantizes at the
  region boundaries.

The quantized pytree (``QParams``) is the JAX package's, field for field:
``conv<i>`` holds ``w_q`` (HWIO int8), ``s_w``, ``bias``, ``in_scale``
and, unless it produces a head, ``out_scale``; a float conv of a hybrid
holds ``w`` (HWIO fp32) and ``bias``; ``__net__`` holds ``input_scale``.
``save_qmodel`` writes it as the JAX package's ``.npz`` artifact, so an
artifact written by either package loads in the other.

On the card the int8 conv is ``ops/int8_conv`` (cuBLASLt's int8 GEMM);
quantile calibration takes its order statistics with the hand-written
radix select (``ops/cuda_topk.radix_select``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from modelcompression_tpu_torch.core.precision import BITMATCH, FAST, Precision
from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, MaxPoolLayer, NetworkSpec, RegionLayer, ReorgLayer, RouteLayer,
    ShortcutLayer, UpsampleLayer, YoloLayer, dump_cfg, parse_cfg,
)
from modelcompression_tpu_torch.models.darknet import (
    Params, _activate, _conv, _nhwc_out, _per_channel, conv_key, maxpool,
    reorg, route_part, upsample_nearest,
)
from modelcompression_tpu_torch.ops.int8_conv import int8_conv

QParams = Dict[str, Dict[str, torch.Tensor]]


def _input_layer_of(spec: NetworkSpec, i: int) -> int:
    """Index of the layer whose output feeds layer ``i`` sequentially
    (-1 = the network input)."""
    return i - 1


def _scale_groups(spec: NetworkSpec) -> List[int]:
    """Union-find over layer outputs that must share one activation scale:
    maxpool, reorg, upsample and the heads join their input's group, a
    route merges all its inputs' groups, a shortcut stays alone. Returns
    the group id per layer index, plus one trailing entry for the network
    input's group (a pool at layer 0 joins the input, not the last
    layer)."""
    n = len(spec.layers)
    parent = list(range(n + 1))  # node n = the network input

    def node(j: int) -> int:
        return n if j < 0 else j

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for i, l in enumerate(spec.layers):
        if isinstance(l, (MaxPoolLayer, ReorgLayer, UpsampleLayer,
                          RegionLayer, YoloLayer)):
            union(i, node(_input_layer_of(spec, i)))
        elif isinstance(l, RouteLayer):
            for a in l.layers:
                union(i, a)
    return [find(i) for i in range(n + 1)]


def _abs_bits_segments(tensors: Sequence[torch.Tensor]):
    """|t| of every tensor as int32 bit patterns, concatenated, with one
    segment id per tensor (int32, ascending)."""
    from modelcompression_tpu_torch.ops.topk_mask import abs_bits
    bits = torch.cat([abs_bits(t.reshape(-1)) for t in tensors])
    seg = torch.cat([torch.full((t.numel(),), s, dtype=torch.int32,
                                device=bits.device)
                     for s, t in enumerate(tensors)])
    return bits, seg


def _quantile_positions(sizes: Sequence[int], q: float):
    """``jnp.quantile``'s linear-interpolation positions for tensors of
    ``sizes`` elements, in its own float32 arithmetic: n cast to float32,
    q·(n − 1), floor and ceil clamped to [0, n − 1], the weights
    pos − low and 1 − (pos − low); the indices clamped again as XLA's
    gather clamps them. Returns (low, high) int64 and (lw, hw) float32."""
    n_f = np.asarray(sizes, np.float64).astype(np.float32)
    last = n_f - np.float32(1)
    pos = np.float32(q) * last
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    lw = np.float32(1) - hw
    low = np.clip(low, np.float32(0), last)
    high = np.clip(high, np.float32(0), last)
    top = np.asarray(sizes, np.int64) - 1
    return (np.clip(low.astype(np.int64), 0, top),
            np.clip(high.astype(np.int64), 0, top), lw, hw)


def abs_quantiles(tensors: Sequence[torch.Tensor], q: float) -> np.ndarray:
    """The ``q`` quantile of |t| for each tensor, as ``jnp.quantile`` of
    the flattened |t| computes it on the CPU (float32, linear
    interpolation). The two order statistics come from the radix select
    (``ops/cuda_topk.radix_select``: the hand-written kernel on a CUDA
    device, its plain version on the CPU), one segment per tensor; the
    interpolation ``low·lw + high·hw`` is taken with ``high·hw`` fused
    into the add, one rounding, as XLA's CPU compiler emits it there."""
    from modelcompression_tpu_torch.ops.cuda_topk import radix_select
    bits, seg = _abs_bits_segments(tensors)
    low, high, lw, hw = _quantile_positions([t.numel() for t in tensors], q)
    n_seg = len(tensors)
    vals = []
    for k in (low, high):
        kth, _ = radix_select(bits, seg, torch.from_numpy(k).to(bits.device),
                              n_seg)
        vals.append(kth.to(torch.int32).view(torch.float32).cpu().numpy())
    lo, hi = vals
    # float64 holds the float32 product high·hw exactly: one rounding
    return (hi.astype(np.float64) * hw.astype(np.float64)
            + (lo * lw).astype(np.float64)).astype(np.float32)


def collect_act_absmax(folded_params: Params, spec: NetworkSpec,
                       batches: Sequence[np.ndarray],
                       quantile: Optional[float] = None
                       ) -> Tuple[np.ndarray, float]:
    """Per-layer output absmax over calibration batches: an fp32 forward
    of the BN-folded params on their device, with TF32 off.

    ``batches``: float images in [0, 1], NHWC (the letterboxed canvas).
    ``quantile``: optional in (0, 1); that quantile of |activation| in
    place of the max (``abs_quantiles``). Returns (absmax per layer
    index, input absmax), the max over the batches of each batch's
    statistic, as the JAX package's."""
    BITMATCH.apply_backend_flags()
    device = next(iter(next(iter(folded_params.values())).values())).device
    absmax = np.zeros(len(spec.layers), np.float32)
    in_max = 0.0
    with torch.inference_mode():
        for b in batches:
            x = torch.as_tensor(np.asarray(b), device=device)
            outs = _calibration_outputs(folded_params, x, spec)
            if quantile is not None:
                stats = abs_quantiles(outs + [x], quantile)
            else:
                stats = torch.stack([t.abs().amax().float()
                                     for t in outs + [x]]).cpu().numpy()
            absmax = np.maximum(absmax, stats[:-1])
            in_max = max(in_max, float(stats[-1]))
    return absmax, in_max


def _calibration_outputs(params: Params, x: torch.Tensor,
                         spec: NetworkSpec) -> List[torch.Tensor]:
    """Every layer's fp32 output (NCHW) of the folded forward on NHWC
    ``x``."""
    outputs: List[torch.Tensor] = []
    y = x.to(torch.float32).permute(0, 3, 1, 2)
    for i, l in enumerate(spec.layers):
        if isinstance(l, ConvLayer):
            p = params[conv_key(i)]
            y = _conv(y, p["w"].float(), l, BITMATCH)
            y = _activate(y + _per_channel(p["bias"], torch.float32),
                          l.activation)
        elif isinstance(l, MaxPoolLayer):
            y = maxpool(y, l)
        elif isinstance(l, RouteLayer):
            y = torch.cat([route_part(outputs[a], l) for a in l.layers],
                          dim=1)
        elif isinstance(l, ReorgLayer):
            y = reorg(y, l.stride)
        elif isinstance(l, ShortcutLayer):
            y = _activate(y + outputs[l.from_layer], l.activation)
        elif isinstance(l, UpsampleLayer):
            y = upsample_nearest(y, l.stride)
        # the heads pass y through unchanged
        outputs.append(y)
    return outputs


def int8_layers_auto(spec: NetworkSpec,
                     min_channels: int = 128) -> List[int]:
    """Conv indices with min(Cin, Cout) >= ``min_channels`` (the JAX
    package's crossover rule, measured on its TPU)."""
    return [i for i, l in enumerate(spec.layers)
            if isinstance(l, ConvLayer)
            and min(l.in_channels, l.filters) >= min_channels]


def resolve_int8_layers(spec: NetworkSpec,
                        selector: str) -> Optional[List[int]]:
    """A CLI layer selector as conv indices (None = all): ``all`` |
    ``auto`` | ``auto:<min_channels>`` | ``3,7,12``."""
    s = selector.strip().lower()
    if s == "all":
        return None
    if s == "auto":
        return int8_layers_auto(spec)
    if s.startswith("auto:"):
        return int8_layers_auto(spec, min_channels=int(s.split(":", 1)[1]))
    return [int(t) for t in s.split(",") if t.strip()]


def _layer_out_scales(spec: NetworkSpec, act_absmax: Sequence[float],
                      input_absmax: float) -> Tuple[List[float], float]:
    """Per-layer activation step (scale-group merged) and the input step:
    the grids PTQ and QAT share."""
    groups = _scale_groups(spec)
    group_max: Dict[int, float] = {groups[-1]: float(input_absmax)}
    for i, g in enumerate(groups[:-1]):
        group_max[g] = max(group_max.get(g, 0.0), float(act_absmax[i]))
    # guard degenerate all-zero activations
    out_scale = [max(group_max[g], 1e-8) / 127.0 for g in groups[:-1]]
    return out_scale, max(group_max[groups[-1]], 1e-8) / 127.0


def _resolve_int8_set(spec: NetworkSpec,
                      int8_layers: Optional[Iterable[int]]
                      ) -> Tuple[List[int], set]:
    """(all conv ids, validated int8 subset: all of them when None)."""
    conv_ids = spec.conv_indices()
    int8_set = set(conv_ids) if int8_layers is None else set(int8_layers)
    if not int8_set <= set(conv_ids):
        raise ValueError(
            f"int8_layers {sorted(int8_set - set(conv_ids))} are not conv "
            f"layers of this spec")
    return conv_ids, int8_set


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def quantize_network(folded_params: Params, spec: NetworkSpec,
                     act_absmax: np.ndarray,
                     input_absmax: float = 1.0,
                     int8_layers: Optional[Iterable[int]] = None) -> QParams:
    """The (possibly hybrid) quantized pytree from BN-folded params (OIHW,
    the port's layout), on their device; fields and layouts as the JAX
    package's (module docstring). The arithmetic is the JAX package's
    numpy code on the HWIO kernel, so the result is bit-equal to its."""
    from modelcompression_tpu_torch.compress.graph import head_producer_convs
    out_scale, input_scale = _layer_out_scales(spec, act_absmax,
                                               input_absmax)
    conv_ids, int8_set = _resolve_int8_set(spec, int8_layers)
    head_convs = head_producer_convs(spec)
    device = next(iter(next(iter(folded_params.values())).values())).device
    qparams: QParams = {"__net__": {"input_scale": _f32(input_scale,
                                                        device)}}
    for i in conv_ids:
        p = folded_params[conv_key(i)]
        w = np.ascontiguousarray(
            p["w"].detach().float().cpu().numpy().transpose(2, 3, 1, 0))
        bias = p["bias"].detach().float().clone()
        if i not in int8_set:
            qparams[conv_key(i)] = {"w": torch.from_numpy(w).to(device),
                                    "bias": bias}
            continue
        s_w = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(axis=0),
                         1e-12) / 127.0
        w_q = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
        j = _input_layer_of(spec, i)
        in_scale = (float(qparams["__net__"]["input_scale"]) if j < 0
                    else out_scale[j])
        entry = {"w_q": torch.from_numpy(w_q).to(device),
                 "s_w": torch.from_numpy(s_w.astype(np.float32)).to(device),
                 "bias": bias, "in_scale": _f32(in_scale, device)}
        if i not in head_convs:
            entry["out_scale"] = _f32(out_scale[i], device)
        qparams[conv_key(i)] = entry
    return qparams


def _requantize(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(y / scale), ±127) as int8; y is cast to fp32 first and
    divided (a CUDA division by a host scalar would multiply by its
    reciprocal instead: ``scale`` is a tensor on y's device)."""
    return torch.clamp(torch.round(y.to(torch.float32) / scale),
                       -127, 127).to(torch.int8)


def _int8_epilogue(y32: torch.Tensor, p: Dict[str, torch.Tensor],
                   activation: str):
    """An int8 conv's epilogue on its NHWC int32 sums, the JAX package's
    ops in its order: fp32 cast, one multiply by the scale product, one
    bias add, the activation, then the requantize, or the raw fp32 map
    for a head producer. Returns (output, its scale or None)."""
    yf = y32.to(torch.float32) * (p["in_scale"] * p["s_w"]) + p["bias"]
    yf = _activate(yf, activation)
    if "out_scale" not in p:
        return yf, None
    return _requantize(yf, p["out_scale"]), p["out_scale"]


def forward_quantized(qparams: QParams, x: torch.Tensor, spec: NetworkSpec,
                      precision: Precision = FAST):
    """Quantized (possibly hybrid) forward on NHWC ``x``: float images in
    [0, 1], or an int8 canvas already on the network-input grid
    (``data.preprocess.quantize_canvas`` with the pytree's
    ``input_scale``). Returns the raw fp32 NHWC map, or for [yolo] specs a
    tuple of per-head maps, as ``darknet.forward_folded``.

    Within an int8 region activations flow as int8; each int8 conv is
    ``ops/int8_conv.int8_conv`` (the card's int8 GEMM on CUDA, the exact
    float64 conv on the CPU) and its epilogue is the JAX package's, op by
    op: the scale product, one multiply, one add, the activation, the
    requantize. Float convs of a hybrid run in ``precision``'s compute
    dtype; each tensor's scale is tracked, and (de)quantization happens
    only at the int8/float boundaries: a float input to an int8 conv, a
    route mixing the two, a shortcut (always a float boundary), a head.
    Activations are NCHW inside (channels-last storage); the int8 conv
    takes and returns their NHWC views."""
    precision.apply_backend_flags()
    outputs: List[torch.Tensor] = []
    scales: List[Optional[torch.Tensor]] = []
    heads: List[torch.Tensor] = []
    y = x.permute(0, 3, 1, 2)
    y_scale = qparams["__net__"]["input_scale"] \
        if x.dtype == torch.int8 else None
    for i in range(len(spec.layers)):
        y, y_scale = quantized_layer(qparams, spec, i, y, y_scale, outputs,
                                     scales, precision)
        if isinstance(spec.layers[i], YoloLayer):
            heads.append(head_map(y, y_scale, precision))
        outputs.append(y)
        scales.append(y_scale)
    return tuple(heads) if heads else head_map(y, y_scale, precision)


def head_map(y: torch.Tensor, y_scale: Optional[torch.Tensor],
             precision: Precision = FAST) -> torch.Tensor:
    """A head's raw fp32 NHWC map from its NCHW input and scale (a head
    that ends inside an int8 region is dequantized in the compute
    dtype first)."""
    if y_scale is not None:
        cdt = precision.compute_dtype
        y = y.to(cdt) * y_scale.to(cdt)
    return _nhwc_out(y.to(torch.float32))


def quantized_layer(qparams: QParams, spec: NetworkSpec, i: int,
                    y: torch.Tensor, y_scale: Optional[torch.Tensor],
                    outputs: Sequence[torch.Tensor],
                    scales: Sequence[Optional[torch.Tensor]],
                    precision: Precision = FAST):
    """Layer ``i`` of ``forward_quantized`` on its input ``y`` (NCHW, the
    previous layer's output) on the grid ``y_scale`` (None: float), with
    the earlier layers' ``outputs`` and ``scales`` for routes and
    shortcuts. Returns the layer's (output, scale); a [yolo] layer passes
    its input through."""
    cdt = precision.compute_dtype
    l = spec.layers[i]

    def dequant(t, s):
        return t.to(cdt) * s.to(cdt)

    if isinstance(l, ConvLayer):
        p = qparams[conv_key(i)]
        if "w_q" in p:
            q_in = y if y_scale is not None \
                else _requantize(y, p["in_scale"])
            y32 = int8_conv(q_in.permute(0, 2, 3, 1), p["w_q"],
                            l.stride, l.padding)
            y, y_scale = _int8_epilogue(y32, p, l.activation)
            return y.permute(0, 3, 1, 2), y_scale
        xin = dequant(y, y_scale) if y_scale is not None else y.to(cdt)
        w = p["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        yf = _conv(xin, w, l, precision)
        return _activate(yf + _per_channel(p["bias"], yf.dtype),
                         l.activation), None
    if isinstance(l, MaxPoolLayer):
        return maxpool(y, l), y_scale
    if isinstance(l, RouteLayer):
        parts = [route_part(outputs[a], l) for a in l.layers]
        part_scales = [scales[a] for a in l.layers]
        if all(s is not None for s in part_scales):
            # one scale group (calibration merged the inputs): exact
            y_scale = part_scales[0]
        else:
            parts = [dequant(t, s) if s is not None else t.to(cdt)
                     for t, s in zip(parts, part_scales)]
            y_scale = None
        return (parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)), \
            y_scale
    if isinstance(l, ReorgLayer):
        return reorg(y, l.stride), y_scale
    if isinstance(l, UpsampleLayer):
        return upsample_nearest(y, l.stride), y_scale
    if isinstance(l, ShortcutLayer):
        a = dequant(y, y_scale) if y_scale is not None else y.to(cdt)
        o, os_ = outputs[l.from_layer], scales[l.from_layer]
        b = dequant(o, os_) if os_ is not None else o.to(cdt)
        return _activate(a + b, l.activation), None
    return y, y_scale


def save_qmodel(path: str, qparams: QParams, spec: NetworkSpec,
                pack: Optional[str] = None) -> None:
    """Write the quantized pytree and the architecture cfg as one ``.npz``
    artifact, the JAX package's format key for key (``__cfg__``,
    ``conv<i>/<field>``, ``__net__/input_scale``). ``pack='huffman'`` (or
    ``'fixed'``) entropy-codes each int8 weight tensor
    (``compress/packing.py``, symbols ``w_q + 128``, K = 256) into the
    ``conv<i>/wq_*`` fields, as the JAX package does; ``load_qmodel``
    unpacks them."""
    from modelcompression_tpu_torch.compress.packing import pack_codes
    flat = {"__cfg__": np.array(dump_cfg(spec))}
    for key, entry in qparams.items():
        for field, v in entry.items():
            v = v.detach().cpu().numpy()
            if pack is not None and field == "w_q":
                sym = (v.astype(np.int16) + 128).astype(np.uint16)
                for pf, pv in pack_codes(sym, 256, pack).items():
                    flat[f"{key}/wq_{pf}"] = pv
            else:
                flat[f"{key}/{field}"] = v
    with open(path, "wb") as f:  # exact path (np would append .npz)
        np.savez_compressed(f, **flat)


def _arch_mismatch(a: NetworkSpec, b: NetworkSpec) -> Optional[str]:
    """First architectural difference between two specs (None if they
    describe the same network); train hyperparameters and the [region]
    loss knobs are not compared."""
    if (a.net.height, a.net.width, a.net.channels) != \
            (b.net.height, b.net.width, b.net.channels):
        return (f"net {a.net.height}x{a.net.width}x{a.net.channels} != "
                f"{b.net.height}x{b.net.width}x{b.net.channels}")
    if len(a.layers) != len(b.layers):
        return f"{len(a.layers)} layers != {len(b.layers)}"
    for i, (la, lb) in enumerate(zip(a.layers, b.layers)):
        if isinstance(la, RegionLayer) and isinstance(lb, RegionLayer):
            def decode_key(l):
                return (l.anchors, l.classes, l.num, l.coords, l.softmax)
            if decode_key(la) != decode_key(lb):
                return f"layer {i}: {la!r} != {lb!r}"
        elif la != lb:
            return f"layer {i}: {la!r} != {lb!r}"
    return None


def load_qmodel(path: str, spec: Optional[NetworkSpec] = None
                ) -> Tuple[QParams, NetworkSpec]:
    """Load a ``save_qmodel`` artifact (written by either package) as CPU
    tensors; returns (qparams, spec). With ``spec`` the artifact's
    embedded architecture must match it (``ValueError`` otherwise).
    Packed int8 weights (``wq_*`` fields) are unpacked."""
    with np.load(path, allow_pickle=False) as z:
        loaded_spec = parse_cfg(str(z["__cfg__"][()]))
        if spec is not None:
            diff = _arch_mismatch(spec, loaded_spec)
            if diff is not None:
                raise ValueError(
                    f"qmodel {path} was saved for a different "
                    f"architecture: {diff}")
        qparams: QParams = {}
        packed: dict = {}
        for k in z.files:
            if k == "__cfg__":
                continue
            key, field = k.rsplit("/", 1)
            if field.startswith("wq_"):
                packed.setdefault(key, {})[field[3:]] = z[k]
            else:
                qparams.setdefault(key, {})[field] = torch.from_numpy(z[k])
    if packed:
        from modelcompression_tpu_torch.compress.packing import unpack_codes
        for key, fields in packed.items():
            w_q = (unpack_codes(fields).astype(np.int16) - 128
                   ).astype(np.int8)
            qparams.setdefault(key, {})["w_q"] = torch.from_numpy(w_q)
    return qparams, (spec if spec is not None else loaded_spec)


def quantize_from_batches(folded_params: Params, spec: NetworkSpec,
                          batches: Sequence[np.ndarray],
                          quantile: Optional[float] = None,
                          int8_layers: Optional[Iterable[int]] = None,
                          ) -> QParams:
    """Calibrate and quantize in one call."""
    absmax, in_max = collect_act_absmax(folded_params, spec, batches,
                                        quantile=quantile)
    return quantize_network(folded_params, spec, absmax,
                            input_absmax=in_max, int8_layers=int8_layers)
