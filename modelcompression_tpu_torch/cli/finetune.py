"""Fine-tune CLI, port of ``modelcompression_tpu/cli/finetune.py``:
post-prune fine-tuning on --device (default cuda; a missing CUDA device is
an error). With ``--preserve-sparsity`` the zero pattern of the loaded
(pruned) weights becomes the fine-tune mask, so pruned weights stay
exactly zero through training. ``--iterate 0.25,0.5,0.75`` drives the
iterative prune -> fine-tune -> eval loop: the structured modes
``l1_filter``, ``bn_gamma``, ``fpgm`` and ``taylor`` (scores on
--taylor-batches batches a round) repack each round (and write the
slimmed cfg), with ``--tied group`` pruning the shortcut-tied groups of
residual networks too; ``magnitude`` / ``global`` / ``lamp`` recompute the
masks each round through the hand-written top-k kernels on CUDA. Every
bundled cfg
trains: [region] (YOLOv2) and [yolo] (YOLOv3 / YOLOv4, the multi-head
loss). Each run ends with an eval (FAST, batch --batch) of the written
model.

``--qat`` fine-tunes with the deployed int8 grids simulated (fake-quant
with the straight-through estimator, compress/qat.py): the activation
grids are calibrated on the first --qat-calib-images training images
(absmax, or --qat-quantile), the --qat-layers convs train int8. After the
float model's eval comes the exported int8 model's, and --save-qmodel
writes that int8 artifact (entropy-coded with --pack).

``--gmp S`` ramps the weight sparsity to S on a cubic schedule inside the
train step (compress/gmp.py): on each due step the masks are recomputed
from the updated weights through the top-k kernels (per layer, or one
threshold with --gmp-global). ``--distill T.weights`` adds the loss
against that teacher's raw map (train/distill.py; --distill-cfg when the
teacher's architecture differs), in every round with --iterate.

``--dp N`` and ``--tp M`` train over a (max(N, 1), M) mesh: one rank
per device of --device (nccl on cuda:0..N*M-1, gloo on the CPU), each
given the same batches. Over the data axis the batch is split and the
BN statistics, loss sums and gradients are all-reduced; over the model
axis each conv whose filter count M divides is split by filters, its
output channels all-gathered (``parallel/``), so the params equal a
one-device run's. Rank 0 alone logs, evaluates and writes --out and the
checkpoints, after every rank has gathered the params whole; a failing
rank fails the command.

The command lines of the JAX CLI run unchanged: its validations come
first, with its messages and exit code 2.

Example:
  python -m modelcompression_tpu_torch.cli.finetune --cfg slim.cfg \\
      --weights slim.weights --data voc.data --steps 1000 \\
      --preserve-sparsity
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from modelcompression_tpu_torch.cli.common import (
    add_data_args, add_model_args, add_parallel_args, build_mesh,
    load_dataset, load_model, load_train_dataset, prep_calibration,
    quantized_eval_config, rank_device, resolve_batch_subdivisions,
    resolve_mask_backend, spawn_ranks,
)
from modelcompression_tpu_torch.compress import (
    DEFAULT_MASK_BACKEND, MASK_BACKENDS, GMPSpec, gmp_init_masks,
    qat_spec_from_batches, quantize_qat, save_qmodel,
)
from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
from modelcompression_tpu_torch.models import (
    dump_cfg, load_cfg, load_weights, params_to, save_weights,
)
from modelcompression_tpu_torch.models.cfg import ConvLayer
from modelcompression_tpu_torch.parallel.ranks import is_primary
from modelcompression_tpu_torch.parallel.sharding import gather_train_state
from modelcompression_tpu_torch.train import (
    BatchLoader, TrainConfig, TrainState, iterative_prune_finetune,
    make_distill_plan, make_optimizer, train,
)
from modelcompression_tpu_torch.train.loop import (
    STRUCTURED_MODES,
)
from modelcompression_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="finetune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    add_data_args(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the model trains and evaluates on (default "
                        "cuda; a missing CUDA device is an error)")
    p.add_argument("--steps", type=int, required=True,
                   help="fine-tune steps (per round when iterating)")
    p.add_argument("--batch", type=int, default=None,
                   help="EFFECTIVE batch per weight update "
                        "(default: cfg batch=)")
    p.add_argument("--subdivisions", type=int, default=None,
                   help="micro-batches accumulated per update (default: "
                        "cfg subdivisions=; 1 = whole batch in one "
                        "forward)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--max-boxes", type=int, default=30)
    p.add_argument("--mosaic", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="4-image mosaic augmentation. Default: the "
                        "cfg's [net] mosaic= flag")
    p.add_argument("--hsv", action="store_true",
                   help="Darknet HSV distortion (knobs from the cfg's "
                        "[net] hue/saturation/exposure)")
    p.add_argument("--jitter", type=float, default=None,
                   help="Darknet crop-jitter fraction in [0, 0.5); "
                        "default: the cfg's [region] jitter value; "
                        "pass 0 to disable")
    p.add_argument("--freeze", type=int, default=0, metavar="N",
                   help="freeze the first N conv layers (Darknet .conv.N "
                        "counting): inference BN on running stats, no "
                        "gradient or weight/stat updates")
    p.add_argument("--ema", type=float, default=None, metavar="DECAY",
                   help="maintain an exponential moving average of the "
                        "weights (ema = d*ema + (1-d)*w after every "
                        "update) and SAVE/EVAL the EMA model. Single-pass "
                        "mode only (not --iterate)")
    p.add_argument("--bn-l1", type=float, default=0.0,
                   help="network-slimming sparsity training: add this L1 "
                        "penalty on all BN gammas; 0 = off")
    p.add_argument("--preserve-sparsity", action="store_true",
                   help="freeze the zero pattern of the loaded weights")
    p.add_argument("--gmp", type=float, default=None, metavar="SPARSITY",
                   help="gradual magnitude pruning (Zhu & Gupta 2017): "
                        "ramp weight sparsity to this final value on a "
                        "cubic schedule, recomputing the masks inside the "
                        "train step (compress/gmp.py)")
    p.add_argument("--gmp-begin", type=int, default=0,
                   help="first step of the GMP ramp (default 0)")
    p.add_argument("--gmp-end", type=int, default=None,
                   help="step at which the ramp reaches the final "
                        "sparsity (default: the run's last step, --steps "
                        "- 1; steps are 0-based, later values are "
                        "rejected)")
    p.add_argument("--gmp-freq", type=int, default=100,
                   help="recompute the masks every this many steps "
                        "(plus once exactly at --gmp-end)")
    p.add_argument("--gmp-initial", type=float, default=0.0,
                   help="sparsity at the start of the ramp (default 0)")
    p.add_argument("--gmp-global", action="store_true",
                   help="one magnitude threshold across all convs instead "
                        "of per-layer sparsity")
    p.add_argument("--distill", default=None, metavar="WEIGHTS",
                   help="knowledge-distillation fine-tune: train against "
                        "this teacher's outputs beside the ground truth "
                        "(train/distill.py); with --iterate every round's "
                        "student distills from it")
    p.add_argument("--distill-cfg", default=None,
                   help="teacher architecture cfg (default: --cfg; must "
                        "share the student's anchors/classes head)")
    p.add_argument("--distill-weight", type=float, default=1.0,
                   help="blend of the distillation loss into the total "
                        "(total = detection + W * distill)")
    p.add_argument("--distill-temp", type=float, default=1.0,
                   help="softmax temperature for the class soft targets "
                        "([region] family; [yolo] classes are distilled "
                        "by MSE)")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware fine-tune: train with the "
                        "deployed int8 grids simulated in the forward "
                        "(straight-through fake-quant; compress/qat.py), "
                        "then report the exported int8 model's mAP next "
                        "to the f32 one")
    p.add_argument("--qat-layers", default="all",
                   help="which convs train+deploy int8 under --qat: "
                        "'all', 'auto[:K]' (min(Cin,Cout) >= K, default "
                        "128), or explicit comma-separated layer indices")
    p.add_argument("--qat-calib-images", type=int, default=8,
                   help="images used to calibrate the static activation "
                        "grids before QAT training")
    p.add_argument("--qat-quantile", type=float, default=None,
                   help="calibrate activation grids at this quantile of "
                        "|activation| instead of the max")
    p.add_argument("--save-qmodel", default=None, metavar="PATH",
                   help="with --qat: also export the trained int8 "
                        "deployment artifact (serve with eval/detect "
                        "--qmodel)")
    p.add_argument("--pack", nargs="?", const="huffman", default=None,
                   choices=("huffman", "fixed"), metavar="METHOD",
                   help="with --save-qmodel: entropy-code the int8 "
                        "weight tensors (compress/packing.py; loading "
                        "is transparent)")
    p.add_argument("--iterate", default=None,
                   help="comma list of cumulative prune fractions for the "
                        "iterative loop, e.g. 0.25,0.5,0.75")
    p.add_argument("--iterate-mode", default="l1_filter",
                   choices=("l1_filter", "bn_gamma", "fpgm", "taylor",
                            "magnitude", "global", "lamp"))
    p.add_argument("--tied", default="protect",
                   choices=("protect", "group"),
                   help="residual-graph policy for the structured "
                        "--iterate modes (same knob as prune --tied): "
                        "'protect' (default) keeps shortcut-tied convs; "
                        "'group' prunes each tied group with ONE shared "
                        "keep-set ranked by group-summed scores")
    p.add_argument("--taylor-batches", type=int, default=8,
                   help="--iterate-mode taylor: training batches per round "
                        "the gate-gradient filter scores average over")
    p.add_argument("--mask-backend", default=DEFAULT_MASK_BACKEND,
                   choices=MASK_BACKENDS,
                   help="magnitude/global mask implementation for "
                        "--iterate (fused/pallas: the hand-written kernels "
                        "on CUDA | reference: the argsort definition)")
    p.add_argument("--use-pallas", action="store_true",
                   help="alias for --mask-backend pallas")
    p.add_argument("--ckpt-dir", default=None,
                   help="save a checkpoint after every iterative round")
    p.add_argument("--resume", action="store_true",
                   help="resume the iterative loop from the latest round "
                        "checkpoint in --ckpt-dir")
    p.add_argument("--out", required=True, help="output .weights path")
    p.add_argument("--out-cfg", default=None,
                   help="output .cfg (written when iterating with repack)")
    p.add_argument("--log-jsonl", default=None)
    p.add_argument("--seed", type=int, default=0)
    add_parallel_args(p)
    return p


def _usage_error(args, spec) -> str | None:
    """The JAX CLI's checks after loading, in its order (its messages)."""
    if args.tied == "group" and (
            not args.iterate or args.iterate_mode not in STRUCTURED_MODES):
        return ("--tied group requires --iterate with a structured "
                "mode (l1_filter | bn_gamma | fpgm | taylor); the masked "
                "modes have no keep-sets to tie")
    if args.preserve_sparsity and args.iterate:
        return ("--preserve-sparsity cannot be combined with "
                "--iterate (the iterative loop re-derives its own masks/"
                "keep-sets each round)")
    if args.gmp is not None and (args.preserve_sparsity or args.iterate):
        return ("--gmp is a standalone sparsification schedule — it "
                "recomputes its own masks, so it cannot be combined with "
                "--preserve-sparsity or --iterate")
    if args.gmp is not None and args.qat:
        return ("--gmp cannot be combined with --qat (the activation "
                "grids are calibrated on the dense model and would go stale "
                "as the sparsity ramps; run GMP first, then QAT the sparse "
                "model)")
    if args.qat and args.iterate:
        return ("--qat cannot be combined with --iterate (each "
                "repack round changes the architecture, so the calibrated "
                "activation grids would go stale; run the iterative prune "
                "loop first, then QAT the slimmed model)")
    if args.save_qmodel and not args.qat:
        return ("--save-qmodel requires --qat (it exports the "
                "trained int8 deployment; for PTQ use eval --int8 "
                "--save-qmodel)")
    if args.pack and not args.save_qmodel:
        return ("--pack entropy-codes a saved artifact; it "
                "requires --save-qmodel")
    n_convs = sum(1 for l in spec.layers if isinstance(l, ConvLayer))
    if not 0 <= args.freeze < n_convs:
        return (f"--freeze {args.freeze} must leave at least one "
                f"trainable conv (network has {n_convs})")
    if args.ema is not None:
        if not 0.0 < args.ema < 1.0:
            return f"--ema decay must be in (0, 1), got {args.ema}"
        if args.iterate:
            return ("--ema is single-pass only: the iterative loop "
                    "repacks the architecture each round, which would "
                    "orphan the EMA buffers")
    if args.jitter is not None and not 0.0 <= args.jitter < 0.5:
        return f"--jitter must be in [0, 0.5), got {args.jitter}"
    try:
        resolve_batch_subdivisions(args, spec)
    except ValueError as e:
        return str(e)
    return None


def _gmp_spec(args) -> GMPSpec:
    """The GMPSpec of --gmp; ValueError with the JAX CLI's message when the
    ramp does not fit in the run's 0-based steps or the spec is invalid."""
    last = args.steps - 1
    if args.gmp_end is not None and args.gmp_end > last:
        raise ValueError(
            f"--gmp-end {args.gmp_end} is past the run's last step {last} "
            f"(steps are 0-based); the ramp would never reach the final "
            f"sparsity")
    if args.gmp_begin >= last:
        raise ValueError(f"--gmp-begin {args.gmp_begin} leaves no room for "
                         f"the ramp (last step is {last})")
    try:
        return GMPSpec(final_sparsity=args.gmp,
                       initial_sparsity=args.gmp_initial,
                       begin=args.gmp_begin,
                       end=args.gmp_end if args.gmp_end is not None
                       else last,
                       frequency=args.gmp_freq,
                       per_layer=not args.gmp_global)
    except ValueError as e:
        raise ValueError(f"--gmp: {e}") from e


def _to_cpu(params):
    return params_to({k: {n: v.detach() for n, v in p.items()}
                      for k, p in params.items()}, "cpu")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.mask_backend = resolve_mask_backend(args)
    try:
        rc = spawn_ranks(args, "modelcompression_tpu_torch.cli.finetune:main",
                         argv)
        mesh = build_mesh(args)[0]
    except ValueError as e:  # a mesh wider than the devices
        print(f"error: {e}", file=sys.stderr)
        return 2
    if rc is not None:  # --dp / --tp: the ranks ran this CLI
        return rc
    device = rank_device(args, mesh)  # no CUDA: raise before reading
    spec, params, seen = load_model(args)
    samples, names = load_train_dataset(args)
    if not samples:
        print("error: dataset is empty", file=sys.stderr)
        return 2
    eval_samples, eval_names = load_dataset(args)
    if not eval_samples:
        print("error: eval dataset is empty (check the .data valid= list "
              "or the devkit image set) — refusing to train for nothing",
              file=sys.stderr)
        return 2
    why = _usage_error(args, spec)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    batch, subdiv = resolve_batch_subdivisions(args, spec)
    dev_params = params_to(params, device)
    qat_spec = None
    if args.qat:
        try:
            int8_sel, chunks, n = prep_calibration(
                spec, samples, args.qat_calib_images, args.qat_layers,
                what="qat")
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        n_sel = "all" if int8_sel is None else str(len(int8_sel))
        print(f"qat: calibrating activation grids on {n} images "
              f"({n_sel} convs int8)...", file=sys.stderr)
        qat_spec = qat_spec_from_batches(dev_params, spec, chunks,
                                         int8_layers=int8_sel,
                                         quantile=args.qat_quantile)
    distill_plan = None
    if args.distill:
        t_spec = load_cfg(args.distill_cfg) if args.distill_cfg else spec
        t_params, _ = load_weights(args.distill, t_spec)
        try:
            distill_plan = make_distill_plan(
                params_to(t_params, device), t_spec, spec,
                weight=args.distill_weight, temp=args.distill_temp)
        except ValueError as e:
            print(f"error: --distill: {e}", file=sys.stderr)
            return 2
        print(f"distilling from teacher {args.distill} "
              f"(weight {args.distill_weight:g}, T {args.distill_temp:g})",
              file=sys.stderr)
    gmp_spec = None
    if args.gmp is not None:
        try:
            gmp_spec = _gmp_spec(args)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    overrides = {}
    if args.ema is not None:
        overrides["ema_decay"] = args.ema
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    if args.jitter is not None:
        overrides["augment_jitter"] = args.jitter
    mosaic = args.mosaic if args.mosaic is not None else spec.net.mosaic
    config = TrainConfig.from_spec(spec, max_boxes=args.max_boxes,
                                   augment_mosaic=mosaic,
                                   augment_hsv=args.hsv,
                                   subdivisions=subdiv, qat=qat_spec,
                                   bn_l1=args.bn_l1, gmp=gmp_spec,
                                   freeze_prefix=args.freeze, **overrides)
    loader = BatchLoader(samples, batch_size=batch,
                         net_h=spec.net.height, net_w=spec.net.width,
                         max_boxes=args.max_boxes, seed=args.seed,
                         device=device)
    logger = MetricsLogger(jsonl_path=args.log_jsonl if is_primary()
                           else None)
    eval_cfg = EvalConfig(batch_size=batch, device=args.device)
    if mesh is not None and (batch // subdiv) % mesh.shape["data"]:
        print(f"error: micro-batch {batch // subdiv} (batch/subdivisions) "
              f"must be divisible by --dp {mesh.shape['data']}",
              file=sys.stderr)
        return 2

    if args.iterate:
        fractions = [float(x) for x in args.iterate.split(",") if x]

        def eval_fn(s, p):
            if not is_primary():  # rank 0 evaluates
                return {}
            res = evaluate(p, s, eval_samples, eval_names, eval_cfg)
            print(res.summary())
            return {"map50": res.map50}

        rounds = iterative_prune_finetune(
            spec, dev_params, config, loader, fractions=fractions,
            steps_per_round=args.steps, eval_fn=eval_fn,
            mode=args.iterate_mode,
            rng=torch.Generator().manual_seed(args.seed), logger=logger,
            ckpt_dir=args.ckpt_dir, resume=args.resume, initial_seen=seen,
            mesh=mesh, mask_backend=args.mask_backend, distill=distill_plan,
            taylor_batches=args.taylor_batches, tied=args.tied)
        if not is_primary():
            return 0
        if not rounds:
            print("nothing to do: all rounds already checkpointed")
            return 0
        final = rounds[-1]
        save_weights(args.out, final.spec, _to_cpu(final.params),
                     seen=final.seen)
        print(f"wrote {args.out}")
        if args.iterate_mode in STRUCTURED_MODES:
            out_cfg = args.out_cfg or os.path.splitext(args.out)[0] + ".cfg"
            with open(out_cfg, "w") as f:
                f.write(dump_cfg(final.spec))
            print(f"wrote {out_cfg}")
        return 0

    weight_masks = {}
    if gmp_spec is not None:
        weight_masks = gmp_init_masks(dev_params, spec, gmp_spec)
        mode = "global" if args.gmp_global else "per-layer"
        print(f"gmp: ramping {mode} sparsity "
              f"{gmp_spec.initial_sparsity:.0%} -> "
              f"{gmp_spec.final_sparsity:.0%} over steps "
              f"[{gmp_spec.begin}, {gmp_spec.end}], mask recompute every "
              f"{gmp_spec.frequency} steps (on {args.device})")
    if args.preserve_sparsity:
        for k, p in dev_params.items():
            m = p["w"] != 0
            if not bool(m.all()):
                weight_masks[k] = m
        kept = {k: float(m.float().mean()) for k, m in weight_masks.items()}
        if kept:
            print(f"preserving sparsity in {len(kept)} layers "
                  f"(avg keep {np.mean(list(kept.values())):.2%})")
        else:
            print("warning: --preserve-sparsity set but weights are dense",
                  file=sys.stderr)

    # the header's images-seen counter gates the region loss's early prior
    # term, which must not re-trigger on a converged model; the UPDATED
    # count is written back to the output header
    state = TrainState.create(dev_params, make_optimizer(config),
                              torch.Generator().manual_seed(args.seed),
                              weight_masks=weight_masks, seen=seen,
                              ema=args.ema is not None)
    state = train(state, spec, config, loader, n_steps=args.steps,
                  logger=logger, mesh=mesh, distill=distill_plan)
    state = gather_train_state(state, mesh, spec)  # every rank gathers
    if not is_primary():
        return 0
    # with --ema the delivered model is the EMA shadow (weights and BN
    # running stats); the live SGD iterate stays in the state only
    out_params = state["ema_params"] if args.ema is not None \
        else state["params"]
    out_params = _to_cpu(out_params)
    save_weights(args.out, spec, out_params, seen=state["seen"])
    print(f"wrote {args.out}"
          + (f" (EMA weights, decay {args.ema:g})"
             if args.ema is not None else ""))
    if gmp_spec is not None:
        masks = state["weight_masks"].values()
        n_total = sum(m.numel() for m in masks)
        n_zero = sum(int((~m).sum()) for m in masks)
        print(f"gmp: final sparsity {n_zero / max(n_total, 1):.2%} "
              f"({n_zero}/{n_total} weights zeroed; zero pattern is baked "
              f"into {args.out} — fine-tune further with "
              f"--preserve-sparsity)")
    res = evaluate(out_params, spec, eval_samples, eval_names, eval_cfg)
    print(res.summary())
    if qat_spec is not None:
        # the deployed int8 model's accuracy, on the grids training
        # rehearsed
        qparams = quantize_qat(out_params, spec, qat_spec)
        qres = evaluate(qparams, spec, eval_samples, eval_names,
                        quantized_eval_config(EvalConfig(
                            batch_size=batch, device=args.device)))
        print("int8 deployment (QAT grids):")
        print(qres.summary())
        if args.save_qmodel:
            save_qmodel(args.save_qmodel, qparams, spec, pack=args.pack)
            print(f"wrote int8 deployment artifact to {args.save_qmodel} "
                  f"(serve with eval/detect --qmodel)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
