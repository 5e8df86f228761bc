"""Training / fine-tuning step, port of
``modelcompression_tpu/train/train_step.py``.

One call of the step does what the JAX package's one jitted program does,
as eager PyTorch on the params' device: normalize and augment, the forward
with batch statistics, the region loss, backward, one SGD update, the mask
re-apply and the BN running-statistic update. Nothing is read back to the
host inside the step; the metrics stay device tensors.

* **State** is a ``TrainState`` dict: the params (trainable tensors with
  ``requires_grad``, BN running statistics without), the ``torch.optim``
  SGD that owns the momentum buffers, the step and images-seen counters
  (host ints), the ``torch.Generator`` of the augment draws, the weight
  and channel masks, and with EMA the shadow params.
* **Masked fine-tune**: weight masks multiply the weights inside the loss,
  so the gradients of pruned weights are exactly zero, and are applied
  again after the update (momentum and weight decay act on zero weights
  too). Channel masks gate conv outputs after the activation. With
  ``TrainConfig.gmp`` the masks are recomputed from the updated weights
  on the schedule's steps (``compress/gmp.py``) before they are applied.
* **Distillation** (``make_train_step(distill=...)``): the teacher's
  inference forward runs on the same augmented batch, and ``weight *
  distill_loss`` joins the detection loss (``train/distill.py``).
* **BN** takes one-pass fp32 statistics, E[y²] − µ² clamped at 0, and
  folds the biased batch variance into the running variance with the
  torch momentum convention: ``F.batch_norm`` would fold the unbiased one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from modelcompression_tpu_torch.compress.gmp import gmp_mask_update
from modelcompression_tpu_torch.core.precision import FAST, Precision
from modelcompression_tpu_torch.data.preprocess import (
    distort_hsv, mosaic4, random_flip, random_jitter,
)
from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, MaxPoolLayer, NetworkSpec, RegionLayer, ReorgLayer,
    RouteLayer, ShortcutLayer, UpsampleLayer, YoloLayer,
)
from modelcompression_tpu_torch.models.darknet import (
    BN_EPS, Params, _activate, _conv, _nhwc_out, _per_channel, conv_bn_act,
    conv_key, maxpool, params_to, reorg, route_part, upsample_nearest,
)
from modelcompression_tpu_torch.train.distill import (
    detection_distill_loss, teacher_forward,
)
from modelcompression_tpu_torch.train.yolo_loss import detection_loss

BN_MOMENTUM = 0.1  # torch BatchNorm2d default (reference repo class)


@dataclasses.dataclass
class TrainConfig:
    """Train hyperparameters; field names and defaults follow the JAX
    package. ``subdivisions`` = S > 1 makes the step's batch the EFFECTIVE
    batch: S strided micro-batches, gradients summed and scaled by 1/S into
    one update, BN statistics per micro-batch (Darknet's semantics).

    ``remat`` recomputes each trainable conv block in the backward
    (``torch.utils.checkpoint``): about one more forward of work for the
    activation memory of one block. ``qat`` (a ``compress.qat.QATSpec``)
    trains the selected convs with the deployed int8 grids simulated:
    fake-quant of each conv's input, weight and output. ``gmp`` (a
    ``compress.gmp.GMPSpec``) recomputes the weight masks on its schedule
    after each update; the train state must hold its masks
    (``gmp_init_masks``)."""

    learning_rate: float = 1e-3
    momentum: float = 0.9
    decay: float = 5e-4
    subdivisions: int = 1
    burn_in: int = 0
    policy: str = "steps"   # constant | steps | step | poly | exp | sig
    max_batches: int = 80200
    power: float = 4.0
    gamma: float = 1.0
    step: int = 1           # [net] step= for the 'step' and 'sig' policies
    steps: Tuple[int, ...] = ()
    scales: Tuple[float, ...] = ()
    precision: Precision = FAST
    augment_flip: bool = True
    augment_mosaic: bool = False
    augment_hsv: bool = False
    # Darknet crop jitter fraction ([region] jitter=); 0 disables
    augment_jitter: float = 0.0
    # Darknet [net] HSV knobs, applied when augment_hsv is on. [net] angle=
    # is not applied: Darknet's detector data path never rotates
    hue: float = 0.1
    saturation: float = 1.5
    exposure: float = 1.5
    max_boxes: int = 30
    remat: bool = False
    qat: Optional[object] = None
    # network-slimming L1 penalty bn_l1 * sum|gamma| over all BN scales
    bn_l1: float = 0.0
    gmp: Optional[object] = None
    # EMA of the full params (weights and BN running stats) after every
    # update: ema = d*ema + (1-d)*params; needs TrainState.create(ema=True)
    ema_decay: float = 0.0
    # freeze the first N convs (Darknet .conv.N counting): inference BN on
    # running stats, no gradient, params restored bit-identical after every
    # update (weight decay would otherwise move them)
    freeze_prefix: int = 0

    @classmethod
    def from_spec(cls, spec: NetworkSpec, **overrides) -> "TrainConfig":
        """Hyperparameters from the cfg: the LR policy, the [net] HSV knobs
        and the head's crop jitter default to the cfg's values;
        ``overrides`` win."""
        n = spec.net
        try:
            jitter = spec.layers[spec.head_indices()[0]].jitter
        except ValueError:  # spec without a detection head
            jitter = 0.0
        kw = dict(learning_rate=n.learning_rate, momentum=n.momentum,
                  decay=n.decay, subdivisions=n.subdivisions,
                  burn_in=n.burn_in, policy=n.policy,
                  max_batches=n.max_batches, power=n.power, gamma=n.gamma,
                  step=n.step, steps=n.steps, scales=n.scales,
                  hue=n.hue, saturation=n.saturation, exposure=n.exposure,
                  augment_jitter=jitter)
        kw.update(overrides)
        return cls(**kw)


def split_trainable(params: Params) -> Tuple[Params, Params]:
    """BN running mean/var are state, not trainable parameters."""
    trainable, stats = {}, {}
    for k, p in params.items():
        trainable[k] = {n: v for n, v in p.items() if n not in ("mean", "var")}
        stats[k] = {n: v for n, v in p.items() if n in ("mean", "var")}
    return trainable, stats


def merge_params(trainable: Params, stats: Params) -> Params:
    return {k: {**trainable[k], **stats.get(k, {})} for k in trainable}


def _trainable_list(params: Params):
    """The trainable tensors in a fixed order (sorted conv key, then name):
    the optimizer's parameter order, which its saved state refers to."""
    trainable, _ = split_trainable(params)
    return [trainable[k][n] for k in sorted(trainable)
            for n in sorted(trainable[k])]


class TrainState(dict):
    """Train state (a dict, as the JAX package's pytree).

    Keys: params, optimizer (the ``torch.optim.SGD`` over the trainable
    tensors; its state holds the momentum buffers), step and seen (ints),
    rng (the ``torch.Generator`` of the augment draws), weight_masks
    ({conv key: bool OIHW}, possibly empty), channel_masks ({layer index:
    (C,) 0/1}, possibly empty), and ema_params when created with ema.
    """

    @staticmethod
    def create(params: Params, tx, rng: torch.Generator,
               weight_masks: Optional[Dict[str, torch.Tensor]] = None,
               channel_masks: Optional[Dict[int, torch.Tensor]] = None,
               copy: bool = True, seen: int = 0,
               ema: bool = False) -> "TrainState":
        """Build a fresh train state on the params' device.

        ``tx``: ``make_optimizer(config)``, called on the trainable
        tensors. ``copy=True`` (default) trains copies, leaving the
        caller's tensors untouched; ``copy=False`` trains the given tensors
        in place. ``seen`` carries the images-seen counter of a loaded
        ``.weights`` header: it gates the region loss's early prior term,
        so fine-tuning a converged model must not restart it at zero."""
        def own(v):
            return v.detach().clone() if copy else v.detach()
        params = {k: {n: own(v) for n, v in p.items()}
                  for k, p in params.items()}
        for v in _trainable_list(params):
            v.requires_grad_(True)
        state = TrainState(
            params=params,
            optimizer=tx(_trainable_list(params)),
            step=0,
            seen=int(seen),
            rng=rng,
            weight_masks={k: own(m) for k, m in (weight_masks or {}).items()},
            channel_masks={k: own(m)
                           for k, m in (channel_masks or {}).items()},
        )
        if ema:  # TrainConfig.ema_decay: shadow copy of the full params
            state["ema_params"] = {k: {n: v.detach().clone()
                                       for n, v in p.items()}
                                   for k, p in params.items()}
        return state


def darknet_lr_schedule(config: TrainConfig):
    """Darknet LR policies (network.c get_current_rate), computed in
    float32 as the JAX package does: during burn-in lr * (step/burn_in)^4
    and no policy; after it the cfg ``policy``:

    * ``constant`` — base lr.
    * ``steps`` — scales[i] applies whenever steps[i] <= step (a leading
      ``-1`` step scales the base lr at once).
    * ``step``  — lr * scale^(step//step_size) (scales[0] or 1).
    * ``poly``  — lr * (1 - step/max_batches)^power.
    * ``exp``   — lr * gamma^step.
    * ``sig``   — lr / (1 + exp(gamma*(step - step_size))).

    Returns ``schedule(step) -> float``.
    """
    f32 = np.float32
    base = config.learning_rate
    pairs = tuple(zip(config.steps, config.scales))
    policy = config.policy
    if policy not in ("constant", "steps", "step", "poly", "exp", "sig"):
        raise ValueError(f"unsupported lr policy {policy!r}")

    def schedule(step) -> float:
        step = int(step)
        step_f = f32(step)
        lr = f32(base)
        if policy == "steps":
            for s, sc in pairs:
                if step >= s:
                    lr = f32(lr * f32(sc))
        elif policy == "step":
            scale = config.scales[0] if config.scales else 1.0
            lr = f32(f32(base) * f32(scale) ** np.floor(
                step_f / f32(max(config.step, 1))))
        elif policy == "poly":
            frac = np.clip(step_f / f32(config.max_batches), f32(0), f32(1))
            lr = f32(f32(base) * (f32(1) - frac) ** f32(config.power))
        elif policy == "exp":
            lr = f32(f32(base) * f32(config.gamma) ** step_f)
        elif policy == "sig":
            lr = f32(f32(base) / (f32(1) + np.exp(
                f32(config.gamma) * (step_f - f32(config.step)))))
        if config.burn_in > 0 and step < config.burn_in:
            frac = min(f32(step) / f32(config.burn_in), f32(1))
            lr = f32(f32(base) * f32(frac) ** 4)
        return float(lr)

    return schedule


def make_optimizer(config: TrainConfig):
    """SGD with momentum and weight decay: ``tx(tensors)`` builds a
    ``torch.optim.SGD``. Its update (d = g + decay*w; buf = momentum*buf +
    d; w -= lr*buf) is optax's ``add_decayed_weights`` then ``sgd``; the
    step sets the learning rate to ``darknet_lr_schedule(config)(step)``
    before each update."""
    return functools.partial(torch.optim.SGD, lr=config.learning_rate,
                             momentum=config.momentum,
                             weight_decay=config.decay)


def augment_batch(config: TrainConfig, x: torch.Tensor,
                  targets: torch.Tensor, gen: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's augment chain on a normalized fp32 batch: jitter (each
    source image its own crop, before the mosaic composes them), mosaic,
    flip, HSV. The draws come from ``gen`` in that order."""
    if config.augment_jitter > 0:
        x, targets = random_jitter(x, targets, gen,
                                   jitter=config.augment_jitter)
    if config.augment_mosaic:
        x, targets = mosaic4(x, targets, gen)
    if config.augment_flip:
        x, targets = random_flip(x, targets, gen)
    if config.augment_hsv:
        x = distort_hsv(x, gen, hue=config.hue, sat=config.saturation,
                        expo=config.exposure)
    return x, targets


def _conv_block_train(y: torch.Tensor, p: Dict[str, torch.Tensor],
                      l: ConvLayer, precision: Precision, bn_reduce=None,
                      copy_in=None):
    """One conv + (batch-stat BN | bias) + activation on NCHW ``y``;
    returns (y, batch stats or None). The statistics are one pass over the
    conv output in fp32, E[y²] − µ², clamped at 0 (``torch.maximum``,
    whose gradient splits a tie as ``jnp.maximum``'s does). Data
    parallel, ``bn_reduce`` maps this rank's stacked (µ, E[y²]) to the
    global micro-batch's, through a collective with a gradient. Tensor
    parallel, ``copy_in`` takes the input into this rank's filter slice
    (``TensorParallel.copy_in``)."""
    if copy_in is not None:
        y = copy_in(y)
    y = _conv(y, p["w"], l, precision)
    stats = None
    if l.batch_normalize:
        y32 = y.to(torch.promote_types(y.dtype, torch.float32))
        mu = y32.mean(dim=(0, 2, 3))
        ex2 = y32.square().mean(dim=(0, 2, 3))
        if bn_reduce is not None:
            mu, ex2 = bn_reduce(torch.stack([mu, ex2]))
        var = torch.maximum(ex2 - mu.square(), torch.zeros_like(mu))
        stats = {"mean": mu, "var": var}
        inv = torch.rsqrt(var + BN_EPS)
        y = (y - _per_channel(mu, y.dtype)) \
            * _per_channel(p["gamma"].to(inv.dtype) * inv, y.dtype) \
            + _per_channel(p["beta"], y.dtype)
    else:
        y = y + _per_channel(p["bias"], y.dtype)
    return _activate(y, l.activation), stats


def _forward_train(params: Params, x: torch.Tensor, spec: NetworkSpec,
                   precision: Precision,
                   channel_masks: Dict[int, torch.Tensor],
                   freeze: frozenset = frozenset(), remat: bool = False,
                   qat=None, bn_reduce=None, tp=None):
    """Training forward on NHWC ``x`` with batch statistics; returns the
    NHWC fp32 raw map and the per-conv batch (mean, var). Frozen convs run
    inference BN on detached params, so no backward reaches them. With
    ``remat`` each trainable conv block keeps only its input for the
    backward and runs again there. With ``qat`` (``compress.qat.QATSpec``)
    each selected conv takes its input fake-quanted on ``in_scale``, its
    weight per output channel, and fake-quants its post-activation output
    on ``out_scale`` (after the channel mask), the boundary placement of
    ``compress/quantize.forward_quantized``. ``bn_reduce`` (data
    parallel) makes the batch statistics the global micro-batch's
    (``_conv_block_train``). With ``tp`` (``parallel.sharding.
    TensorParallel``) each conv it shards runs on this rank's filters
    (``params`` hold only those) with its BN moments reduced by
    ``tp.bn_reduce``, masks and fake-quants its channel slice, and is
    gathered to the full map; every other layer runs whole on every rank
    of the model group."""
    if qat is not None:
        from modelcompression_tpu_torch.compress.qat import (
            fake_quant, fake_quant_weight,
        )
    outputs = []
    heads = []
    batch_stats: Dict[str, Dict[str, torch.Tensor]] = {}
    y = precision.cast_in(x).permute(0, 3, 1, 2)  # channels-last NCHW
    for i, l in enumerate(spec.layers):
        if isinstance(l, ConvLayer):
            key = conv_key(i)
            p = params[key]
            shard = tp is not None and key in tp.sharded
            reduce, copy_in = ((tp.bn_reduce, tp.copy_in) if shard
                               else (bn_reduce, None))
            q_out = None
            if qat is not None and i in qat.int8:
                p = dict(p, w=fake_quant_weight(p["w"]))
                y = fake_quant(y, qat.in_scale[i])
                q_out = qat.out_scale.get(i)
            if key in freeze:
                y = conv_bn_act(y, {n: v.detach() for n, v in p.items()},
                                l, precision)
            else:
                if remat:
                    # the recompute in the backward runs reduce's
                    # collective again, in the same order on every rank
                    y, stats = torch.utils.checkpoint.checkpoint(
                        _conv_block_train, y, p, l, precision, reduce,
                        copy_in, use_reentrant=False)
                else:
                    y, stats = _conv_block_train(y, p, l, precision,
                                                 reduce, copy_in)
                if stats is not None:
                    batch_stats[key] = stats
            if i in channel_masks:
                cm = channel_masks[i]
                y = y * _per_channel(tp.local(cm) if shard else cm, y.dtype)
            if q_out is not None:
                y = fake_quant(y, q_out)
            if shard:
                y = tp.gather(y)
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
            pass
        outputs.append(y)
    if heads:
        return tuple(heads), batch_stats
    return _nhwc_out(y), batch_stats


def _gmp_shards(params: Params, tp):
    """GMP under tensor parallelism, on a due step: (every conv's full
    weights, a sharded one's gathered over the model group; a function
    giving this rank's rows of a conv's full mask)."""
    from modelcompression_tpu_torch.parallel import ranks
    full = {k: {"w": (ranks.all_gather_rows(p["w"].detach(), tp.model_group)
                      if k in tp.sharded else p["w"])}
            for k, p in params.items()}
    return full, lambda k, m: tp.local(m) if k in tp.sharded else m


def make_train_step(spec: NetworkSpec, config: TrainConfig, distill=None,
                    mesh=None):
    """Build the train step.

    step(state, images (B,H,W,3) uint8 or float, targets (B,M,5))
      -> (state, metrics)

    ``state`` is updated in place and returned. Images and targets may be
    numpy arrays or tensors; they are moved to the params' device. With
    ``config.subdivisions = S > 1`` micro-batch s takes the strided
    elements {s, S+s, 2S+s, ...}; its gradients are summed, scaled by 1/S
    into one update, and the running stats are folded once per micro-batch
    in order. Metrics are 0-dim device tensors (means over micro-batches)
    plus ``lr``, a float.

    With ``distill`` (a ``train.distill.DistillPlan``) the teacher's
    inference forward runs on the whole augmented batch, each micro-batch
    takes the teacher map's same strided rows, and ``weight *
    distill_loss`` joins the detection loss in the gradient; the metrics
    gain ``loss_distill`` and ``loss`` stays the detection loss. The
    teacher params are moved to the params' device once. With
    ``config.gmp`` the metrics gain ``sparsity``, the achieved sparsity
    over the state's weight masks.

    ``mesh`` (a ``core.mesh.Mesh``): one process per device of the mesh
    (``parallel/ranks.py``), each rank given the same global batch. The
    step does what the JAX package's sharded program does. Over the
    'data' axis: every rank augments the global batch with the same draws
    and keeps the rows of its data index d, the d-th contiguous chunk of
    each (strided) micro-batch; the BN statistics and the loss sums are
    all-reduced per micro-batch, so the running statistics and every
    metric are the global batch's; the gradients are averaged before the
    update, so the params, the masks (GMP recomputes them on every rank),
    the EMA and ``seen`` stay equal on every rank. Over the 'model' axis
    (tensor parallel), each conv whose filters the axis divides
    (``parallel.sharding.param_specs``) holds only the filters of the
    rank's model index m in the state (``place_train_state(tp=True)``):
    it convolves the full input with them, takes its BN moments over the
    data group, and all-gathers its channels over the model group; every
    other layer and the loss run whole on each rank of the model group.
    A replicated conv's BN moments and gradients are averaged over every
    rank (its copies in a model group are equal), a sharded conv's over
    its data group. With GMP the masks are recomputed on the weights
    gathered over the model group, as one device computes them, and each
    rank keeps its rows. A mesh of one device outside a process group is
    the plain step."""
    spec.head_indices()  # every spec has [region]/[yolo]
    # BITMATCH trains with TF32 off for cuDNN convs and cuBLAS matmuls
    config.precision.apply_backend_flags()
    subdivisions = max(int(config.subdivisions), 1)
    schedule = darknet_lr_schedule(config)

    conv_indices = spec.conv_indices()
    if not 0 <= config.freeze_prefix < len(conv_indices):
        raise ValueError(
            f"freeze_prefix={config.freeze_prefix} must leave at least one "
            f"trainable conv (network has {len(conv_indices)})")
    freeze_keys = frozenset(
        conv_key(i) for i in conv_indices[:config.freeze_prefix])

    dp, row, bn_reduce, metric_reduce, tp = 1, 0, None, None, None
    grad_group = None  # conv key -> (the group, its size) of its gradient
    if mesh is not None:
        from modelcompression_tpu_torch.parallel import ranks
        from modelcompression_tpu_torch.parallel.sharding import (
            TensorParallel, sharded_keys,
        )
        dp = mesh.shape["data"]
        world = mesh.size
        grid = ranks.grid()
        if grid is None and world > 1:
            raise ValueError(
                f"a parallel train step over {world} devices runs one "
                f"process per device: start the ranks with "
                f"parallel.ranks.spawn (finetune / train --dp / --tp)")
        if grid is not None:
            if grid.mesh.shape != mesh.shape:
                raise ValueError(
                    f"mesh {mesh.shape} != the process group's mesh "
                    f"{grid.mesh.shape}")
            row = grid.d

            def bn_reduce(t):  # replicated convs: every rank
                return ranks.all_reduce_sum(t) / world

            def metric_reduce(t):
                return ranks.all_reduce_sum_(t, grid.data_group)

            sharded = sharded_keys(spec, mesh.shape["model"])
            if sharded:
                tp = TensorParallel(
                    grid.m, mesh.shape["model"], sharded, grid.model_group,
                    lambda t: ranks.all_reduce_sum(t, grid.data_group) / dp)

            def grad_group(key):
                return ((grid.data_group, dp) if key in sharded
                        else (None, world))

    def full_sum(sums: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum of {conv key: this rank's sum over a tensor of it} over
        the full tensors: a sharded conv's slices summed over the model
        group."""
        total = sum(sums.values())
        local = [v for k, v in sums.items() if tp is not None
                 and k in tp.sharded]
        if not local:
            return total
        part = sum(local)
        return total - part + ranks.all_reduce_sum_(
            part.reshape(1).clone(), tp.model_group)[0]

    def full_numel(tensors: Dict[str, torch.Tensor]) -> int:
        return sum(t.numel() * (tp.size if tp is not None
                                and k in tp.sharded else 1)
                   for k, t in tensors.items())

    teacher = {}  # device -> the teacher params there

    def teacher_params(dev):
        if dev not in teacher:
            teacher[dev] = params_to(distill.teacher_params, dev)
        return teacher[dev]

    def loss_fn(params, x, targets, seen, channel_masks, weight_masks,
                t_raw=None):
        if weight_masks:
            params = {k: (dict(p, w=p["w"] * weight_masks[k].to(p["w"].dtype))
                          if k in weight_masks else p)
                      for k, p in params.items()}
        raw, batch_stats = _forward_train(params, x, spec, config.precision,
                                          channel_masks, freeze=freeze_keys,
                                          remat=config.remat, qat=config.qat,
                                          bn_reduce=bn_reduce, tp=tp)
        metrics = detection_loss(raw, targets, spec, seen,
                                 reduce=metric_reduce)
        md = metrics.as_dict()
        loss = metrics.loss
        if t_raw is not None:
            d = detection_distill_loss(raw, t_raw, spec, temp=distill.temp,
                                       coord_scale=distill.coord_scale,
                                       obj_scale=distill.obj_scale,
                                       class_scale=distill.class_scale)
            md["loss_distill"] = d.detach()
            if metric_reduce is not None:  # the mean over the rows
                md["loss_distill"] = metric_reduce(
                    d.detach().reshape(1).clone())[0] / dp
            loss = loss + distill.weight * d
        if config.bn_l1 > 0:
            # slimming penalty; gamma_l1 (the MEAN |gamma|) is reported.
            # Tensor parallel, each rank's penalty holds its own gamma
            # slices (their gradient), the metric every gamma
            part = {k: torch.sum(torch.abs(p["gamma"].float()))
                    for k, p in params.items() if "gamma" in p}
            total_abs = sum(part.values())
            md["gamma_l1"] = full_sum({k: v.detach()
                                       for k, v in part.items()}) \
                / max(full_numel({k: params[k]["gamma"] for k in part}), 1)
            loss = loss + config.bn_l1 * total_abs
        md["loss"] = md["loss"].detach()
        return loss, md, batch_stats

    def step(state: TrainState, images, targets):
        params = state["params"]
        dev = next(iter(next(iter(params.values())).values())).device
        images = torch.as_tensor(images).to(dev)
        targets = torch.as_tensor(targets).to(dev, torch.float32)
        gen = state["rng"]
        b = images.shape[0]
        if b % subdivisions:
            raise ValueError(f"effective batch {b} is not divisible by "
                             f"subdivisions={subdivisions}")
        if (images.dtype == torch.uint8 and config.augment_flip
                and config.augment_jitter == 0
                and not config.augment_mosaic):
            # fine-tune fast path: flip the uint8 batch before the fp32
            # normalize (a permutation and a select: the same result as
            # flipping after it, on a quarter of the bytes)
            images_f, targets = random_flip(images, targets, gen)
            x = images_f.float() / 255.0
            if config.augment_hsv:
                x = distort_hsv(x, gen, hue=config.hue,
                                sat=config.saturation, expo=config.exposure)
        else:
            x = images.float()
            if images.dtype == torch.uint8:
                x = x / 255.0
            x, targets = augment_batch(config, x, targets, gen)
        if mesh is not None:
            # this rank's rows of the global batch: the contiguous chunk
            # whose strided micro-batches are the d-th chunks of the
            # global ones
            if (b // subdivisions) % dp:
                raise ValueError(
                    f"micro-batch {b // subdivisions} not divisible by "
                    f"data-parallel size {dp}")
            lo = row * (b // dp)
            x, targets = x[lo:lo + b // dp], targets[lo:lo + b // dp]

        # the teacher on the same augmented batch, whole: no gradient, so
        # one layer's activations live at a time
        t_raw = None
        if distill is not None:
            t_raw = teacher_forward(distill, teacher_params(dev), x,
                                    config.precision)

        def micro(a, s):
            if a is None or subdivisions == 1:
                return a
            if isinstance(a, tuple):
                return tuple(t[s::subdivisions] for t in a)
            return a[s::subdivisions]

        opt = state["optimizer"]
        opt.zero_grad(set_to_none=True)
        seen = state["seen"]
        mets, stats_updates = [], []
        for s in range(subdivisions):
            loss, md, bstats = loss_fn(params, micro(x, s),
                                       micro(targets, s), seen,
                                       state["channel_masks"],
                                       state["weight_masks"],
                                       micro(t_raw, s))
            loss.backward()
            mets.append(md)
            stats_updates.append({k: {n: v.detach() for n, v in bs.items()}
                                  for k, bs in bstats.items()})
        trainable = _trainable_list(params)
        if subdivisions > 1:
            inv_s = 1.0 / subdivisions
            for v in trainable:
                if v.grad is not None:
                    v.grad.mul_(inv_s)
        if grad_group is not None:
            # the mean gradient, one flat all-reduce per group (in the
            # same order on every rank): a sharded conv's over its data
            # group, the rest over every rank
            owner = {id(v): k for k, p in params.items() for v in p.values()}
            by_group = {}
            for v in trainable:
                if v.grad is not None:
                    by_group.setdefault(grad_group(owner[id(v)]),
                                        []).append(v.grad)
            for (group, n), grads in by_group.items():
                flat = ranks.all_reduce_sum_(
                    torch.cat([g.reshape(-1) for g in grads]), group)
                flat.div_(n)
                for g, part in zip(grads, flat.split([g.numel()
                                                      for g in grads])):
                    g.copy_(part.view_as(g))
        with torch.no_grad():
            # frozen convs have no gradient: a zero one lets SGD move their
            # momentum as optax does (decay acts on it), and the saved
            # values are put back after the update
            frozen = {k: {n: v.clone() for n, v in params[k].items()}
                      for k in freeze_keys}
            for v in trainable:
                if v.grad is None:
                    v.grad = torch.zeros_like(v)
            lr = schedule(state["step"])
            for g in opt.param_groups:
                g["lr"] = lr
            opt.step()
            for k, saved in frozen.items():
                for n, v in saved.items():
                    params[k][n].copy_(v)
            # gradual magnitude pruning: the masks recomputed from the
            # updated weights when the schedule says so (the gradients
            # above used the old masks: prune after the update)
            if config.gmp is not None:
                state["weight_masks"] = gmp_mask_update(
                    config.gmp, spec, params, state["weight_masks"],
                    state["step"], shards=None if tp is None
                    else functools.partial(_gmp_shards, params, tp))
            # keep pruned weights exactly zero (with GMP, the application
            # of a fresh mask): momentum and decay would move them off zero
            for k, m in state["weight_masks"].items():
                params[k]["w"].mul_(m.to(params[k]["w"].dtype))
            # BN running stats (torch momentum convention), one update per
            # micro-batch forward in order, Darknet's pacing
            for bs_i in stats_updates:
                for k, bs in bs_i.items():
                    for n in ("mean", "var"):
                        params[k][n].copy_((1 - BN_MOMENTUM) * params[k][n]
                                           + BN_MOMENTUM * bs[n])
            if "ema_params" in state:
                if config.ema_decay > 0:
                    d = config.ema_decay
                    for k, p in state["ema_params"].items():
                        for n, e in p.items():
                            e.copy_(e * d + params[k][n] * (1.0 - d))
            elif config.ema_decay > 0:
                raise ValueError(
                    "config.ema_decay > 0 requires a train state created "
                    "with TrainState.create(..., ema=True): there is no "
                    "EMA buffer to fold into")
        out = {k: (mets[0][k] if subdivisions == 1
                   else torch.stack([m[k] for m in mets]).mean())
               for k in mets[0]}
        out["lr"] = lr
        if config.gmp is not None:  # over the full masks
            masks = state["weight_masks"]
            n_kept = full_sum({k: m.sum() for k, m in masks.items()})
            out["sparsity"] = 1.0 - n_kept.float() / full_numel(masks)
        state["step"] += 1
        state["seen"] += b
        return state, out

    return step
