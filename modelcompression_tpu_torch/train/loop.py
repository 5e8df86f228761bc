"""Training loops, port of ``modelcompression_tpu/train/loop.py``.

``train`` runs N steps of the train step on prefetched device batches,
with periodic metrics, eval and checkpointing. ``iterative_prune_finetune``
is the reference's outer loop: repeat { prune more -> fine-tune -> eval }
until the target sparsity.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence

import torch

from modelcompression_tpu_torch.compress import (
    DEFAULT_MASK_BACKEND, channel_masks_from_keep, lamp_masks,
    magnitude_mask_fn, repack, taylor_filter_keep_sets,
    uniform_filter_fraction_keep_sets,
)
from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params, params_to
from modelcompression_tpu_torch.parallel.ranks import is_primary
from modelcompression_tpu_torch.parallel.sharding import (
    gather_params, gather_train_state,
)
from modelcompression_tpu_torch.train.loader import BatchLoader
from modelcompression_tpu_torch.train.train_step import (
    TrainConfig, TrainState, make_optimizer, make_train_step,
)
from modelcompression_tpu_torch.utils.logging import MetricsLogger
from modelcompression_tpu_torch.utils.profiling import StepTimer

STRUCTURED_MODES = ("l1_filter", "bn_gamma", "fpgm", "taylor")
MASKED_MODES = ("magnitude", "global", "lamp")


def train(state: TrainState, spec: NetworkSpec, config: TrainConfig,
          loader: BatchLoader, n_steps: int,
          logger: Optional[MetricsLogger] = None,
          eval_fn: Optional[Callable[[Params], Dict[str, float]]] = None,
          eval_every: int = 0,
          checkpoint_fn: Optional[Callable[[int, TrainState], None]] = None,
          checkpoint_every: int = 0,
          metrics_every: int = 10,
          initial_step: int = 0,
          mesh=None, distill=None) -> TrainState:
    """Run ``n_steps`` train steps; returns the final state.

    Metrics stay on the device and are copied to the host only every
    ``metrics_every`` steps and at the last step (each copy waits for the
    device). ``initial_step``: the restored global step when resuming, so
    logging, eval and checkpoint cadences continue the uninterrupted run's
    numbering. ``distill`` (a ``train.distill.DistillPlan``) adds the
    teacher's loss to every step.

    ``mesh`` (``core.mesh.Mesh``): one process per device of the mesh
    (``parallel/ranks.py``; each rank calls ``train`` with the same loader
    stream and the same full state). The state is placed on this rank's
    device, with its filters of each sharded conv when the mesh has a
    model axis (tensor parallel), and the step does what the JAX
    package's sharded program does (``make_train_step``). The loader's
    batch size must divide the data axis. Tensor parallel, ``eval_fn``
    takes the params and ``checkpoint_fn`` the state gathered whole
    (``parallel.sharding``), which every rank gathers when either is due:
    so every rank passes the same functions (doing nothing off rank 0),
    and the returned state is the rank's shard
    (``gather_train_state`` makes it whole)."""
    if mesh is not None:
        from modelcompression_tpu_torch.parallel import (
            place_train_state, ranks,
        )
        dp = mesh.shape.get("data", 1)
        if loader.batch_size % dp:
            raise ValueError(
                f"batch {loader.batch_size} not divisible by data-parallel "
                f"size {dp}")
        state = place_train_state(state, mesh, spec,
                                  tp=mesh.shape["model"] > 1,
                                  rank=ranks.rank() or 0)
    step_fn = make_train_step(spec, config, distill=distill, mesh=mesh)
    logger = logger or MetricsLogger()
    timer = StepTimer()
    it = iter(loader)
    for i in range(n_steps):
        images, targets = next(it)
        state, metrics = step_fn(state, images, targets)
        step = initial_step + i + 1
        last = i == n_steps - 1
        timer.tick(images.shape[0])  # host-side counters only, no sync
        if (metrics_every and step % metrics_every == 0) or last:
            # float() waits for this step's device work, so the timer's
            # wall clock is accurate at every sync point
            host_metrics = {k: float(v) for k, v in metrics.items()}
            host_metrics["img_per_sec"] = timer.images_per_sec
            logger.log(step, host_metrics, force=last)
        if eval_fn and eval_every and step % eval_every == 0:
            logger.log(step, eval_fn(whole_params(state["params"], spec,
                                                  mesh)),
                       prefix="eval")
        if checkpoint_fn and checkpoint_every and \
                step % checkpoint_every == 0:
            checkpoint_fn(step, gather_train_state(state, mesh, spec))
    return state


def whole_params(params: Params, spec: NetworkSpec, mesh=None) -> Params:
    """The params detached, gathered whole over the mesh's model axis
    when it has one (a collective: every rank calls it)."""
    if mesh is None:
        return _detached(params)
    return gather_params(params, mesh, spec)


@dataclasses.dataclass
class IterativeRound:
    round_idx: int
    fraction: float
    spec: NetworkSpec
    params: Params
    eval_metrics: Dict[str, float]
    seen: int = 0  # cumulative images-seen after this round's fine-tune


def _detached(params: Params) -> Params:
    return {k: {n: v.detach() for n, v in p.items()}
            for k, p in params.items()}


def iterative_prune_finetune(
        spec: NetworkSpec, params: Params, config: TrainConfig,
        loader: BatchLoader,
        fractions: Sequence[float],
        steps_per_round: int,
        eval_fn: Callable[[NetworkSpec, Params], Dict[str, float]],
        mode: str = "l1_filter",
        rng: Optional[torch.Generator] = None,
        logger: Optional[MetricsLogger] = None,
        repack_each_round: bool = True,
        ckpt_dir: Optional[str] = None,
        resume: bool = False,
        initial_seen: int = 0,
        mesh=None,
        mask_backend: str = DEFAULT_MASK_BACKEND,
        distill=None,
        taylor_batches: int = 8,
        tied: str = "protect") -> List[IterativeRound]:
    """The reference's iterative loop on the params' device.

    ``fractions`` is the cumulative prune schedule (e.g. 0.25, 0.5, 0.75).
    The structured modes (``l1_filter`` | ``bn_gamma`` | ``fpgm`` |
    ``taylor``) rank the filters of the current (already slimmed) model
    each round, prune the incremental fraction and physically repack
    (``repack_each_round``; else channel masks), then fine-tune the
    smaller dense network. ``taylor`` measures its scores on
    ``taylor_batches`` batches taken from ``loader``'s stream.
    ``magnitude`` / ``global`` recompute the weight masks each round
    through ``compress.magnitude_mask_fn(mode, mask_backend)``, ``lamp``
    through ``compress.lamp_masks`` (on CUDA params, both run the
    hand-written top-k kernels), and fine-tune with them. With
    ``distill`` every round's student distills from the same (original)
    teacher.

    ``tied`` is the residual-graph policy of the structured modes:
    ``protect`` leaves shortcut-tied convs unpruned; ``group`` prunes each
    tied group with one shared keep-set ranked by group-summed scores
    (taylor: group-summed gate gradients).

    ``rng`` (a ``torch.Generator``) seeds one generator per round, drawn
    before the resume skip, so a resumed run trains round i with the draws
    an uninterrupted run would. With ``ckpt_dir`` each round saves its
    params and masks with its arch cfg; ``resume`` continues after the
    latest round.

    ``mesh``: one process per device (``train``); every rank computes
    the same masks or keep-sets on the full params, and only the primary
    process (rank 0) writes the round checkpoints. With a model axis each
    round's fine-tune runs on the shards of the pruned (repacked) model,
    sharded again by its widths (a conv whose new width the axis no
    longer divides runs replicated), and gathers them whole after it.
    """
    if tied not in ("protect", "group"):
        raise ValueError(f"tied must be 'protect' or 'group', got {tied!r}")
    if tied == "group" and mode not in STRUCTURED_MODES:
        raise ValueError(
            f"tied='group' composes with the structured modes "
            f"(l1_filter | bn_gamma | fpgm | taylor), not {mode!r}")
    if mode not in STRUCTURED_MODES + MASKED_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    rng = rng if rng is not None else torch.Generator().manual_seed(0)
    logger = logger or MetricsLogger()
    rounds: List[IterativeRound] = []
    prev_frac = 0.0
    weight_masks: Dict[str, torch.Tensor] = {}
    start_round = 0
    seen_running = initial_seen
    device = next(iter(next(iter(params.values())).values())).device

    if ckpt_dir and resume:
        from modelcompression_tpu_torch.utils.checkpoint import (
            latest_checkpoint, load_checkpoint,
        )
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            spec, saved, meta = load_checkpoint(latest)
            params = params_to(saved["params"], device)
            weight_masks = {k: v.to(device)
                            for k, v in saved.get("weight_masks", {}).items()}
            prev_frac = float(meta["fraction"])
            start_round = int(meta["round"]) + 1
            seen_running = int(meta.get("seen", initial_seen))
            logger.log(start_round,
                       {"resumed_fraction": prev_frac}, prefix="resume")

    for ridx, frac in enumerate(fractions):
        # drawn BEFORE the resume skip so a resumed run consumes the same
        # seed sequence an uninterrupted run would
        round_seed = int(torch.randint(0, 2 ** 62, (), generator=rng))
        if ridx < start_round:
            continue
        with torch.no_grad():
            if mode in STRUCTURED_MODES:
                # incremental fraction relative to the remaining filters
                inc = 1.0 - (1.0 - frac) / (1.0 - prev_frac)
                if mode == "taylor":
                    # scores of the current (slimmed, fine-tuned) model on
                    # training batches off the shared loader stream
                    keep_sets = taylor_filter_keep_sets(
                        params, spec,
                        itertools.islice(iter(loader), taylor_batches), inc,
                        seen=seen_running, precision=config.precision,
                        tied=tied)
                else:
                    keep_sets = uniform_filter_fraction_keep_sets(
                        spec, params, inc,
                        criterion={"bn_gamma": "bn_gamma",
                                   "fpgm": "fpgm"}.get(mode, "l1"),
                        tied=tied)
                if repack_each_round:
                    spec, params = repack(spec, params, keep_sets)
                    channel_masks = {}
                else:
                    channel_masks = channel_masks_from_keep(
                        spec, keep_sets, device=device)
            else:
                if mode == "lamp":
                    weight_masks = lamp_masks(params, spec, frac)
                else:
                    fn = magnitude_mask_fn(mode, mask_backend)
                    weight_masks = fn(params, spec, frac)
                channel_masks = {}

        state = TrainState.create(
            params, make_optimizer(config),
            torch.Generator().manual_seed(round_seed),
            weight_masks=weight_masks, channel_masks=channel_masks,
            seen=seen_running)
        state = train(state, spec, config, loader, steps_per_round,
                      logger=logger, mesh=mesh, distill=distill)
        params = whole_params(state["params"], spec, mesh)
        seen_running = state["seen"]
        metrics = eval_fn(spec, params)
        logger.log(state["step"], dict(metrics, fraction=frac),
                   prefix=f"round{ridx}")
        rounds.append(IterativeRound(ridx, frac, spec, params, metrics,
                                     seen=seen_running))
        prev_frac = frac
        if ckpt_dir and is_primary():
            from modelcompression_tpu_torch.utils.checkpoint import (
                save_checkpoint,
            )
            save_checkpoint(
                ckpt_dir, ridx, spec,
                {"params": params, "weight_masks": weight_masks},
                extra={"round": ridx, "fraction": frac, "mode": mode,
                       "seen": seen_running,
                       "metrics": {k: float(v) for k, v in metrics.items()}})
    return rounds
