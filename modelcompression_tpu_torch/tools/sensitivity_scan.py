"""Per-layer pruning-sensitivity scan (Li et al. 2017 §4, "Pruning
Filters for Efficient ConvNets"): for each prunable conv INDEPENDENTLY,
drop k% of its filters (L1 ranking + physical repack of just that
layer's fan-out), evaluate mAP@50, and print the sensitivity matrix:
the measurement that justifies a non-uniform `prune --fractions`
schedule.

Usage:
  python -m modelcompression_tpu_torch.tools.sensitivity_scan \\
      --cfg net.cfg --weights w.weights --data voc.data \\
      [--fractions 0.25,0.5,0.75] [--layers 0,2,5] [--batch 8] \\
      [--device cuda|cpu]

Each (layer, fraction) cell repacks to a different architecture and runs
one full evaluation on ``--device``; --layers / --fractions bound the
scan (a full 22-conv x 3-fraction scan of YOLOv2-VOC is 66 evaluations).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--image-set", default="test")
    p.add_argument("--fractions", default="0.25,0.5,0.75")
    p.add_argument("--layers", default=None,
                   help="comma list of conv layer indices (default: all "
                        "prunable convs)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.005)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from modelcompression_tpu_torch.cli.common import load_dataset
    from modelcompression_tpu_torch.compress import (
        l1_filter_keep_sets_scheduled, repack,
    )
    from modelcompression_tpu_torch.core.device import resolve_device
    from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
    from modelcompression_tpu_torch.models import (
        ConvLayer, load_cfg, load_weights, params_to,
    )

    device = resolve_device(args.device)
    spec = load_cfg(args.cfg)
    params, _ = load_weights(args.weights, spec)
    params = params_to(params, device)
    samples, names = load_dataset(args)
    if not samples:
        print("error: dataset is empty", file=sys.stderr)
        return 2
    fractions = [float(x) for x in args.fractions.split(",") if x]
    cfg = EvalConfig(batch_size=args.batch, conf_thresh=args.conf,
                     device=device.type)

    conv_idx = spec.conv_indices()
    prunable = conv_idx[:-1]  # detection conv protected
    if args.layers:
        want = {int(x) for x in args.layers.split(",") if x}
        bad = want - set(prunable)
        if bad:
            print(f"error: not prunable conv indices: {sorted(bad)}",
                  file=sys.stderr)
            return 2
        prunable = [i for i in prunable if i in want]

    base = evaluate(params, spec, samples, names, cfg).map50
    print(f"baseline mAP@50 {base * 100:.2f}  "
          f"({len(samples)} images, fractions {fractions})")
    header = "conv idx (filters)".ljust(22) + "".join(
        f"  drop {f:.0%} " for f in fractions)
    print(header)
    for i in prunable:
        filters = spec.layers[i].filters
        if not isinstance(spec.layers[i], ConvLayer):
            raise TypeError(f"layer {i} is not a conv layer")
        row = f"conv[{i:>2}] ({filters:>4})".ljust(22)
        for f in fractions:
            keep = l1_filter_keep_sets_scheduled(params, spec, {i: f},
                                                 default=0.0)
            sspec, sparams = repack(spec, params, keep)
            m = evaluate(sparams, sspec, samples, names, cfg).map50
            row += f"  {m * 100:6.2f}  "
        print(row, flush=True)
    print("rows: mAP@50 after pruning ONLY that conv at each fraction "
          "(no fine-tune) — flat rows are insensitive layers, steep rows "
          "deserve a smaller fraction in the --fractions schedule")
    return 0


if __name__ == "__main__":
    sys.exit(main())
