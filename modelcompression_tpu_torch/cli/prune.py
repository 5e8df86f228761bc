"""Prune CLI, port of ``modelcompression_tpu/cli/prune.py``.

Modes:
  magnitude   per-layer unstructured magnitude masks at --sparsity
  global      one global |w| threshold at --sparsity
  lamp        layer-adaptive global magnitude (Lee et al. 2021): one global
              rank over w^2 / per-layer surviving-mass suffix sums, so the
              per-layer allocation is automatic; --sparsity
  l1_filter   L1-norm filter ranking at --fraction (or a per-layer
              --fractions schedule) + physical channel repack; writes a
              rewritten cfg beside the slimmed weights. Every filter mode
              also takes --target-flops F in place of a fraction: automatic
              per-layer allocation to a conv-FLOP budget (global
              layer-normalized rank, compress/flops.py)
  bn_gamma    network slimming (BN |gamma| filter ranking), same repack
  fpgm        geometric-median filter ranking (He et al. 2019): prune the
              filters nearest their layer's geometric median; same repack
  taylor      first-order Taylor filter ranking (Molchanov et al. 2017):
              |sum a * dL/da| measured on --score-batches training batches
              of --batch images from --data (required); same repack
  lowrank     SVD-factor each conv into kxk->r linear + 1x1 (r chosen by
              --energy or --rank, under the --max-cost FLOPs guard);
              writes a rewritten cfg whose factored layers are plain convs

--tied group prunes each shortcut-tied group of a residual network with
one shared keep-set ranked by group-summed scores (the filter modes; the
default, protect, leaves those convs unpruned).

The params are read on the CPU, moved to --device (default cuda; a
missing CUDA device is an error), masked, scored and ranked there, and
brought back to be written. On a CUDA device the magnitude masks run the
hand-written top-k/mask kernels (ops/cuda_topk.py), as does lamp's global
cut; --mask-backend reference selects the stable-argsort definition for
magnitude and global. lowrank's SVD runs in numpy on the host. --sweep
writes one file per point; with --data it also evaluates each point's
model on the dataset (mAP@50, evaluation/pipeline.evaluate, batch
--batch, on --device).

Examples:
  python -m modelcompression_tpu_torch.cli.prune \
      --cfg yolov2-voc.cfg --weights yolov2.weights \
      --mode magnitude --sparsity 0.75 --out pruned.weights
  python -m modelcompression_tpu_torch.cli.prune \
      --cfg yolov4-voc.cfg --weights yolov4.weights \
      --mode fpgm --tied group --target-flops 0.5 --out slim.weights
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

from modelcompression_tpu_torch.cli.common import (
    add_model_args, load_dataset, load_model, load_train_dataset,
    resolve_mask_backend,
)
from modelcompression_tpu_torch.compress import (
    DEFAULT_MASK_BACKEND, MASK_BACKENDS, SCORE_NORMS, apply_masks,
    csp_balanced_scores_device, factor_network, filter_scores_device,
    flop_targeted_keep_sets, keep_sets_from_scores,
    l1_filter_keep_sets_scheduled, lamp_layer_sparsities, lamp_masks,
    magnitude_mask_fn, mask_sparsity, repack,
    taylor_filter_scores_device, taylor_scores_all,
    taylor_scores_with_groups, tied_group_scores_device, total_conv_flops,
    uniform_filter_fraction_keep_sets,
)
from modelcompression_tpu_torch.compress.criteria import _keep_from_scores
from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
from modelcompression_tpu_torch.models import (
    dump_cfg, num_params, params_to, save_weights,
)
from modelcompression_tpu_torch.train.loader import BatchLoader

# structured filter modes -> compress.criteria score criterion
_FILTER_MODE_CRITERION = {"l1_filter": "l1", "bn_gamma": "bn_gamma",
                          "fpgm": "fpgm"}
_FILTER_MODES = tuple(_FILTER_MODE_CRITERION) + ("taylor",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--mode", default="magnitude",
                   choices=("magnitude", "global", "lamp", "l1_filter",
                            "bn_gamma", "fpgm", "taylor", "lowrank"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the masks and scores are computed on "
                        "(default cuda; a missing CUDA device is an error)")
    p.add_argument("--sparsity", type=float, default=None,
                   help="target weight sparsity (magnitude/global/lamp "
                        "modes)")
    p.add_argument("--fraction", type=float, default=None,
                   help="filter drop fraction (l1_filter/bn_gamma/fpgm/"
                        "taylor modes)")
    p.add_argument("--score-batches", "--taylor-batches", type=int,
                   default=8,
                   help="taylor mode: number of training batches (of "
                        "--batch images from --data) the gate-gradient "
                        "scores are averaged over")
    p.add_argument("--score-seed", "--taylor-seed", type=int, default=0,
                   help="taylor mode: shuffle seed for the scoring batches")
    p.add_argument("--taylor-sq", action="store_true",
                   help="taylor mode: squared gate-gradient importance "
                        "(Molchanov et al. 2019) instead of the 2017 "
                        "|sum a*dL/da|")
    p.add_argument("--tied", default="protect", choices=("protect", "group"),
                   help="residual ([shortcut]) graph policy for filter "
                        "modes: 'protect' (default) keeps shortcut-tied "
                        "convs unpruned; 'group' prunes each tied group "
                        "with ONE shared keep-set ranked by group-summed "
                        "scores (no effect on chain graphs like YOLOv2)")
    p.add_argument("--fractions", default=None,
                   help="per-layer drop fractions for the filter modes as "
                        "'convidx:frac,convidx:frac' (e.g. '0:0.25,2:0.5'); "
                        "unlisted prunable convs use --fraction (or 0)")
    p.add_argument("--target-flops", type=float, default=None,
                   help="filter modes: automatic per-layer allocation to a "
                        "conv-FLOP budget: drop globally-lowest "
                        "layer-normalized-score filters until the network "
                        "keeps this fraction of its conv FLOPs/img "
                        "(replaces --fraction/--fractions). Prints the "
                        "discovered per-layer schedule")
    p.add_argument("--min-filters", type=int, default=1,
                   help="--target-flops: floor of surviving filters per "
                        "prunable conv (default 1)")
    p.add_argument("--score-norm", default="l2", choices=SCORE_NORMS,
                   help="--target-flops: cross-layer score normalization "
                        "for the global rank (default l2, Molchanov et al. "
                        "2019 eq. 8)")
    p.add_argument("--out", required=True, help="output .weights path")
    p.add_argument("--out-cfg", default=None,
                   help="rewritten .cfg path (filter modes; magnitude "
                        "modes write the unchanged architecture)")
    p.add_argument("--mask-backend", default=DEFAULT_MASK_BACKEND,
                   choices=MASK_BACKENDS,
                   help="magnitude/global mask implementation: 'fused' "
                        "(default) and 'pallas' are both the hand-written "
                        "top-k/mask kernels on CUDA (their plain PyTorch "
                        "versions on the CPU); 'reference' is the "
                        "stable-argsort definition")
    p.add_argument("--use-pallas", action="store_true",
                   help="alias for --mask-backend pallas")
    p.add_argument("--sweep", default=None,
                   help="comma list of sparsities/fractions: prune at each "
                        "point and write <out stem>_<pct>.weights")
    p.add_argument("--data", default=None,
                   help="dataset (.data file, VOCdevkit root or COCO json) "
                        "for sweep evaluation and taylor scoring")
    p.add_argument("--image-set", default="test",
                   help="VOCdevkit image set for sweep evaluation")
    p.add_argument("--batch", type=int, default=8,
                   help="sweep evaluation and taylor scoring batch size")
    p.add_argument("--energy", type=float, default=0.9,
                   help="lowrank mode: per-layer rank = smallest r whose "
                        "singular values keep this fraction of the "
                        "spectral energy (Eckart-Young truncation)")
    p.add_argument("--rank", default=None,
                   help="lowrank mode: factor ONLY the listed layers, as "
                        "'convidx:r,convidx:r' (--energy is ignored; "
                        "combine with --max-cost to lift the FLOPs guard)")
    p.add_argument("--max-cost", type=float, default=1.0,
                   help="lowrank mode: factor a conv only when the "
                        "factored FLOPs are below this fraction of the "
                        "original")
    return p


def _taylor_scores(args, spec, params, seen, device, with_groups=False,
                   full=False):
    """Gate-gradient Taylor scores from --score-batches training batches
    (compress/taylor.py), shuffled by the loader's seeded generator as in
    the JAX CLI. ``with_groups=True`` returns ``(untied_scores,
    group_scores)`` from the same pass; ``full=True`` returns ``(untied,
    group, csp)``, the budget allocator's whole input."""
    samples, _ = load_train_dataset(args)
    loader = BatchLoader(samples, args.batch, spec.net.height,
                         spec.net.width, seed=args.score_seed,
                         drop_last=False, device=device)
    batches = itertools.islice(iter(loader), args.score_batches)
    if full:
        return taylor_scores_all(params, spec, batches, seen=seen,
                                 second_moment=args.taylor_sq)
    if with_groups:
        return taylor_scores_with_groups(params, spec, batches, seen=seen,
                                         second_moment=args.taylor_sq)
    return taylor_filter_scores_device(params, spec, batches, seen=seen,
                                       second_moment=args.taylor_sq)


def _magnitude(args, spec, dev_params, sparsity):
    """(pruned device params, masks, achieved sparsity) of the masked
    modes: magnitude, global, lamp."""
    if args.mode == "lamp":
        masks = lamp_masks(dev_params, spec, sparsity)
    else:
        masks = magnitude_mask_fn(args.mode, args.mask_backend)(
            dev_params, spec, sparsity)
    return apply_masks(dev_params, masks), masks, mask_sparsity(masks)


def _write_cfg(path, spec):
    with open(path, "w") as f:
        f.write(dump_cfg(spec))


def _sweep(args, spec, params, seen, device) -> int:
    points = [float(x) for x in args.sweep.split(",") if x]
    for v in points:
        if not 0.0 <= v < 1.0:
            print(f"error: sweep point {v} out of [0, 1)", file=sys.stderr)
            return 2
    samples = names = None
    if args.data:
        samples, names = load_dataset(args)
    dev_params = params_to(params, device)
    tay_scores = None
    if args.mode == "taylor":
        if not args.data:
            print("error: taylor mode needs --data (scores are measured "
                  "on training batches)", file=sys.stderr)
            return 2
        # scores are fraction-independent: measure once, rank per point
        tay_scores = _taylor_scores(args, spec, dev_params, seen, device)
    stem = os.path.splitext(args.out)[0]
    rows = []
    for v in points:
        pct = int(round(v * 100))
        out = f"{stem}_{pct}.weights"
        if args.mode in _FILTER_MODES:
            if args.mode == "taylor":
                keep = keep_sets_from_scores(tay_scores, v)
            else:
                keep = uniform_filter_fraction_keep_sets(
                    spec, dev_params, v,
                    criterion=_FILTER_MODE_CRITERION[args.mode],
                    tied=args.tied)
            out_spec, out_params = repack(spec, dev_params, keep)
            achieved = 1.0 - num_params(out_params) / num_params(params)
            _write_cfg(f"{stem}_{pct}.cfg", out_spec)
        else:
            out_spec = spec
            out_params, _, achieved = _magnitude(args, spec, dev_params, v)
        save_weights(out, out_spec, params_to(out_params, "cpu"), seen=seen)
        map50 = None
        if samples is not None:
            map50 = evaluate(out_params, out_spec, samples, names,
                             EvalConfig(batch_size=args.batch,
                                        device=args.device)).map50
        rows.append((v, achieved, map50))
        print(f"sweep {v:.0%}: achieved {achieved:.2%} -> {out}"
              + (f"  mAP@50 {map50 * 100:.2f}" if map50 is not None
                 else ""))
    print(f"{'point':>6} {'achieved':>9} {'mAP@50':>8}")
    for v, achieved, map50 in rows:
        print(f"{v:6.0%} {achieved:9.2%} "
              + (f"{map50 * 100:8.2f}" if map50 is not None else "      --"))
    return 0


def _parse_fractions(text):
    sched = {}
    for tok in text.split(","):
        if not tok.strip():
            continue
        idx, _, val = tok.partition(":")
        f = float(val)
        if not 0.0 <= f < 1.0:
            raise ValueError(f"fraction {f} out of [0, 1)")
        sched[int(idx)] = f
    return sched


def _filter_usage_error(args):
    """The JAX CLI's checks of a filter-mode command line (its messages),
    or None."""
    if (args.fraction is None and args.fractions is None
            and args.target_flops is None):
        return (f"--fraction, --fractions or --target-flops is required for "
                f"{args.mode} mode")
    if args.target_flops is not None and (args.fraction is not None
                                          or args.fractions is not None):
        return ("--target-flops replaces --fraction/--fractions (it "
                "discovers the per-layer schedule itself)")
    if args.tied == "group" and args.fractions is not None:
        return ("--tied group composes with --fraction or --target-flops, "
                "not a per-layer --fractions schedule (tied groups share "
                "one keep-set, which has no per-layer schedule)")
    if args.fraction is not None and not 0.0 <= args.fraction < 1.0:
        return f"--fraction must be in [0, 1), got {args.fraction}"
    if args.mode == "taylor" and not args.data:
        return ("taylor mode needs --data (scores are measured on training "
                "batches)")
    return None


def _structured(args, spec, params, seen, device) -> int:
    """l1_filter / bn_gamma / fpgm / taylor: keep-sets, repack, write."""
    why = _filter_usage_error(args)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    criterion = _FILTER_MODE_CRITERION.get(args.mode, "l1")
    n0 = num_params(params)
    dev_params = params_to(params, device)
    tay_scores = tay_gscores = tay_cscores = None
    if args.mode == "taylor":
        if args.target_flops is not None:
            # untied + tied-group + balanced-CSP gate scores, one pass
            tay_scores, tay_gscores, tay_cscores = _taylor_scores(
                args, spec, dev_params, seen, device, full=True)
        elif args.tied == "group":
            tay_scores, tay_gscores = _taylor_scores(
                args, spec, dev_params, seen, device, with_groups=True)
        else:
            tay_scores = _taylor_scores(args, spec, dev_params, seen,
                                        device)
    if args.target_flops is not None:
        scores = (tay_scores if args.mode == "taylor"
                  else filter_scores_device(dev_params, spec,
                                            criterion=criterion))
        # CSP grouped-route sources join the allocation as balanced-step
        # rank units, tied groups (--tied group) as single rank units
        cscores = (tay_cscores if args.mode == "taylor"
                   else csp_balanced_scores_device(dev_params, spec,
                                                   criterion=criterion))
        gscores = None
        if args.tied == "group":
            gscores = (tay_gscores if args.mode == "taylor"
                       else tied_group_scores_device(dev_params, spec,
                                                     criterion=criterion))
        try:
            keep, sched = flop_targeted_keep_sets(
                spec, scores, args.target_flops,
                min_filters=args.min_filters, norm=args.score_norm,
                group_scores=gscores, csp_scores=cscores)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        base_fl = total_conv_flops(spec)
        got_fl = total_conv_flops(spec, {i: len(k) for i, k in keep.items()})
        print(f"flop-targeted allocation ({args.mode}, "
              f"norm={args.score_norm}): {base_fl / 1e9:.2f} -> "
              f"{got_fl / 1e9:.2f} GFLOP/img ({got_fl / base_fl:.4f} "
              f"of base, target {args.target_flops:g})")
        print("  discovered schedule (reusable as --fractions): "
              + ",".join(f"{i}:{f:.3f}" for i, f in sorted(sched.items())))
        what = (f"filters to a {args.target_flops:g} conv-FLOP budget "
                "(auto per-layer allocation)")
    elif args.fractions is not None:
        try:
            sched = _parse_fractions(args.fractions)
            if args.mode == "taylor":
                keep = keep_sets_from_scores(tay_scores, fractions=sched,
                                             default=args.fraction or 0.0)
            else:
                keep = l1_filter_keep_sets_scheduled(
                    dev_params, spec, sched, default=args.fraction or 0.0,
                    criterion=criterion)
        except ValueError as e:
            print(f"error: bad --fractions: {e}", file=sys.stderr)
            return 2
        what = f"per-layer schedule {args.fractions}"
    else:
        if args.mode == "taylor":
            keep = keep_sets_from_scores(tay_scores, args.fraction)
            for g, sc in (tay_gscores or {}).items():
                ks = _keep_from_scores(np.asarray(sc), args.fraction)
                for i in g:
                    keep[i] = ks
        else:
            keep = uniform_filter_fraction_keep_sets(
                spec, dev_params, args.fraction, criterion=criterion,
                tied=args.tied)
        what = f"{args.fraction:.0%} of filters per prunable conv"
    slim_spec, slim_params = repack(spec, dev_params, keep)
    save_weights(args.out, slim_spec, params_to(slim_params, "cpu"),
                 seen=seen)
    print(f"{args.mode} prune: dropped {what}; params {n0 / 1e6:.1f}M -> "
          f"{num_params(slim_params) / 1e6:.1f}M")
    print(f"wrote {args.out}")
    out_cfg = args.out_cfg or os.path.splitext(args.out)[0] + ".cfg"
    _write_cfg(out_cfg, slim_spec)
    print(f"wrote {out_cfg} (slimmed architecture — use it for "
          "eval/fine-tune)")
    return 0


def _lowrank(args, spec, params, seen) -> int:
    """SVD-factor the convs (compress/lowrank.py, numpy on the host) and
    write the factored weights and cfg."""
    ranks = {}
    if args.rank:
        try:
            for tok in args.rank.split(","):
                if not tok.strip():
                    continue
                idx, _, val = tok.partition(":")
                ranks[int(idx)] = int(val)
        except ValueError as e:
            print(f"error: bad --rank: {e}", file=sys.stderr)
            return 2
    if not 0.0 < args.energy <= 1.0:
        print(f"error: --energy must be in (0, 1], got {args.energy}",
              file=sys.stderr)
        return 2
    try:
        fac_spec, fac_params, report = factor_network(
            params, spec, energy=args.energy, ranks=ranks,
            max_cost=args.max_cost)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    save_weights(args.out, fac_spec, fac_params, seen=seen)
    for e in report:
        print(f"  conv{e.layer_idx}: rank {e.rank}/{e.full_rank} "
              f"(energy {e.energy_kept:.4f}, cost x{e.cost_ratio:.2f})")
    print(f"lowrank: factored {len(report)} convs at energy>="
          f"{args.energy:g}; params {num_params(params) / 1e6:.1f}M -> "
          f"{num_params(fac_params) / 1e6:.1f}M")
    print(f"wrote {args.out}")
    out_cfg = args.out_cfg or os.path.splitext(args.out)[0] + ".cfg"
    _write_cfg(out_cfg, fac_spec)
    print(f"wrote {out_cfg} (factored architecture — use it for "
          "eval/fine-tune)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.mask_backend = resolve_mask_backend(args)
    device = resolve_device(args.device)
    spec, params, seen = load_model(args)

    if args.sweep:
        if args.mode == "lowrank":
            print("error: --sweep sweeps sparsities/fractions; lowrank "
                  "mode selects ranks by --energy/--rank (run per energy "
                  "point instead)", file=sys.stderr)
            return 2
        return _sweep(args, spec, params, seen, device)
    if args.mode in _FILTER_MODES:
        return _structured(args, spec, params, seen, device)
    if args.mode == "lowrank":
        return _lowrank(args, spec, params, seen)

    if args.sparsity is None:
        print(f"error: --sparsity is required for {args.mode} mode",
              file=sys.stderr)
        return 2
    if not 0.0 <= args.sparsity < 1.0:
        print(f"error: --sparsity must be in [0, 1), got {args.sparsity}",
              file=sys.stderr)
        return 2
    pruned, masks, achieved = _magnitude(
        args, spec, params_to(params, device), args.sparsity)
    if args.mode == "lamp":
        per_layer = lamp_layer_sparsities(masks)
        print("lamp per-layer allocation: "
              f"min {min(per_layer.values()):.2%}, "
              f"max {max(per_layer.values()):.2%} "
              f"over {len(per_layer)} convs")
    save_weights(args.out, spec, params_to(pruned, "cpu"), seen=seen)
    print(f"{args.mode} prune: target sparsity {args.sparsity:.2%}, "
          f"achieved {achieved:.2%} over "
          f"{sum(m.numel() for m in masks.values())} weights")
    print(f"wrote {args.out}")
    if args.out_cfg:
        _write_cfg(args.out_cfg, spec)
        print(f"wrote {args.out_cfg} (architecture unchanged)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
