"""Quantization-aware fine-tuning (QAT), port of
``modelcompression_tpu/compress/qat.py``.

The train step (``train/train_step.py``, ``TrainConfig.qat``) simulates
the deployed int8 grids of ``compress/quantize.forward_quantized`` with
fake-quant and the straight-through estimator: each selected conv's input
on its ``in_scale`` grid, its weight on per-output-channel grids taken
from the current |w| at every step, its post-activation output on its
``out_scale`` grid (head producers keep a float output). The activation
grids are static, calibrated once with the same scale-group merging the
deployed program uses; ``quantize_qat`` exports the int8 pytree on exactly
those grids.

Workflow::

    qat = qat_spec_from_batches(params, spec, calib_batches,
                                int8_layers=int8_layers_auto(spec))
    config = TrainConfig.from_spec(spec, qat=qat)
    ...train...
    qparams = quantize_qat(state["params"], spec, qat)
    y = forward_quantized(qparams, x, spec)

CLI surface: ``finetune --qat [--qat-layers auto[:K]] [--save-qmodel]``.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from modelcompression_tpu_torch.compress.quantize import (
    QParams, _layer_out_scales, _resolve_int8_set, collect_act_absmax,
    quantize_network,
)
from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params, fold_batchnorm


@dataclasses.dataclass(frozen=True)
class QATSpec:
    """Static quantization plan for a QAT fine-tune.

    ``int8``: conv layer indices trained with fake-quant. ``in_scale`` /
    ``out_scale``: per-conv activation grids (``out_scale`` absent for
    head producers). ``act_absmax`` / ``input_absmax`` keep the raw
    calibration, so ``quantize_qat`` exports on exactly the grids
    training rehearsed."""

    int8: FrozenSet[int]
    in_scale: Mapping[int, float]
    out_scale: Mapping[int, float]
    act_absmax: Tuple[float, ...]
    input_absmax: float


def _on(x: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as an fp32 0-dim tensor on x's device: CUDA divides by a host
    scalar as a multiply by its reciprocal, which is not the division."""
    return x.new_full((), v, dtype=torch.float32)


def fake_quant(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Straight-through fake quantization on a fixed symmetric int8 grid.

    Forward: clip(round(x/scale), ±127) · scale, computed in fp32 as
    ``x + (q − x)``, as the JAX package writes it. Backward: the identity
    (the gradient flows through ``x``; ``q − x`` is detached)."""
    xf = x.to(torch.float32)
    s = _on(xf, scale)
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0) * s
    return (xf + (q - xf).detach()).to(x.dtype)


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """STE fake-quant of an OIHW conv weight on per-output-channel grids:
    absmax / 127 over the input-channel and spatial axes (the first three
    axes of HWIO), floored at 1e-12, taken from the current |w| and
    detached, as ``quantize_network``'s rule."""
    wf = w.to(torch.float32)
    s = torch.amax(torch.abs(wf), dim=tuple(range(1, wf.dim())),
                   keepdim=True)
    s = (torch.clamp_min(s, 1e-12) / _on(s, 127.0)).detach()
    q = torch.clamp(torch.round(wf / s), -127.0, 127.0) * s
    return (wf + (q - wf).detach()).to(w.dtype)


def qat_spec_from_absmax(spec: NetworkSpec,
                         act_absmax: Sequence[float],
                         input_absmax: float,
                         int8_layers: Optional[Iterable[int]] = None
                         ) -> QATSpec:
    """The QAT plan from a calibration profile (same inputs and grids as
    ``quantize_network``)."""
    from modelcompression_tpu_torch.compress.graph import head_producer_convs
    out_scales, input_scale = _layer_out_scales(spec, act_absmax,
                                                input_absmax)
    _, int8_set = _resolve_int8_set(spec, int8_layers)
    head_convs = head_producer_convs(spec)
    in_scale, out_scale = {}, {}
    for i in sorted(int8_set):
        in_scale[i] = input_scale if i == 0 else out_scales[i - 1]
        if i not in head_convs:
            out_scale[i] = out_scales[i]
    return QATSpec(int8=frozenset(int8_set), in_scale=in_scale,
                   out_scale=out_scale,
                   act_absmax=tuple(float(a) for a in act_absmax),
                   input_absmax=float(input_absmax))


def qat_spec_from_batches(params: Params, spec: NetworkSpec,
                          batches: Sequence[np.ndarray],
                          int8_layers: Optional[Iterable[int]] = None,
                          quantile: Optional[float] = None) -> QATSpec:
    """Calibrate the activation grids on the BN-folded model (the form
    deployment quantizes) and build the QAT plan. ``batches``: float
    images in [0, 1], NHWC, the letterboxed canvas."""
    folded = fold_batchnorm(_detached(params), spec)
    absmax, in_max = collect_act_absmax(folded, spec, batches,
                                        quantile=quantile)
    return qat_spec_from_absmax(spec, absmax, in_max,
                                int8_layers=int8_layers)


def _detached(params: Params) -> Params:
    return {k: {n: v.detach() for n, v in p.items()}
            for k, p in params.items()}


def quantize_qat(params: Params, spec: NetworkSpec, qat: QATSpec
                 ) -> QParams:
    """Export the deployed int8 pytree after a QAT fine-tune: BN-fold,
    then quantize on exactly the activation grids training rehearsed (the
    weight grids re-derive from the final weights, as the per-step grids
    of ``fake_quant_weight`` do)."""
    folded = fold_batchnorm(_detached(params), spec)
    return quantize_network(folded, spec,
                            np.asarray(qat.act_absmax, np.float32),
                            input_absmax=qat.input_absmax,
                            int8_layers=sorted(qat.int8))
