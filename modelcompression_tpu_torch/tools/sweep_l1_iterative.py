"""The headline accuracy-contract shape (BASELINE.json:5,9,10) on the
learnable fixture: train to high mAP, then the iterative filter-prune loop
0.25 -> 0.5 -> 0.75 with PHYSICAL repack each round, measuring mAP@50
right after each prune (drop) and after each round's fine-tune
(recovery). The 0.75 row is the fixture-task stand-in for the
"<= 2.0 mAP@50 drop at 75% filter pruning" contract until real VOC
exists.

    python -m modelcompression_tpu_torch.tools.sweep_l1_iterative \\
        [--family v2|v3|v4] [--criterion l1|bn_gamma|fpgm|taylor] \\
        [--tied protect|group] [--base-steps N] [--round-steps N] \\
        [--chmul M] [--device cuda|cpu]

``--family {v2,v3,v4}`` selects the detector family's fixture:

* ``v2``: the region-head chain graph (tiny_region_cfg).
* ``v3``: the [yolo] shortcut/FPN graph (tiny_yolo3_cfg); pair with
  ``--tied group`` for the identity-path-slimming recipe.
* ``v4``: the CSP grouped-route graph (tiny_yolo4_cfg) trained with its
  canonical iou_loss=ciou; the CSP source convs prune with
  split-BALANCED keep-sets (the uniform-path default).

``--criterion {l1,bn_gamma,fpgm,taylor}`` selects the filter-ranking
criterion so the structured criteria can be compared head-to-head on the
identical schedule and seeds (taylor scores on 4 training batches per
round, compress/taylor.py). Every evaluation runs on ``--device``, through
the input-stage kernel on the card at each round's first-conv width.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import tempfile

import torch

from modelcompression_tpu_torch.data.fixtures import (
    tiny_region_cfg, tiny_yolo3_cfg, tiny_yolo4_cfg,
)
from modelcompression_tpu_torch.tools.sweep_fixture import (
    EVAL, NET, fixture, train_steps,
)

FRACTIONS = (0.25, 0.5, 0.75)
BASE_STEPS = 600
ROUND_STEPS = 400


FAMILY_CFGS = {
    "v2": lambda mul: tiny_region_cfg(num_classes=3, width=NET, height=NET),
    "v3": lambda mul: tiny_yolo3_cfg(num_classes=3, width=NET, height=NET),
    "v4": lambda mul: tiny_yolo4_cfg(num_classes=3, width=NET, height=NET,
                                     iou_loss="ciou", chmul=mul),
}


def run(family: str = "v2", criterion: str = "l1", tied: str = "protect",
        chmul: int = 1, base_steps: int = BASE_STEPS,
        round_steps: int = ROUND_STEPS, device="cuda"):
    """The sweep. Prints the JAX tool's lines and returns
    {"base", "rounds": [{fraction, inc, spec_before, params_before, keep,
    spec, pruned, recovered, params} per round]}: each round's params
    and spec before its prune, its keep-sets, the repacked spec, the mAP
    after the prune and after the fine-tune, and the fine-tuned params."""
    from modelcompression_tpu_torch.compress import (
        repack, taylor_filter_keep_sets, uniform_filter_fraction_keep_sets,
    )
    from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
    from modelcompression_tpu_torch.models import (
        init_params, num_params, params_to, parse_cfg,
    )
    from modelcompression_tpu_torch.train import BatchLoader
    device = torch.device(device)
    cfg = EvalConfig(device=device.type, **EVAL)
    with tempfile.TemporaryDirectory() as td:
        samples, _, names = fixture(td)
        spec = parse_cfg(FAMILY_CFGS[family](chmul))
        params = params_to(init_params(spec, seed=0), device)
        params, loss = train_steps(spec, params, samples, base_steps,
                                   seed=1, device=device)
        base = evaluate(params, spec, samples, names, cfg).map50
        print(f"family: {family}  criterion: {criterion}"
              + (f"  tied: {tied}" if tied != "protect" else ""))
        print(f"baseline: {base_steps} steps, loss {loss:.2f}, "
              f"mAP@50 {base*100:.1f}, params {num_params(params)/1e3:.0f}k")
        rounds = []
        prev_frac = 0.0
        for ridx, frac in enumerate(FRACTIONS):
            inc = 1.0 - (1.0 - frac) / (1.0 - prev_frac)
            spec_before, params_before = spec, params
            with torch.no_grad():
                if criterion == "taylor":
                    score_loader = BatchLoader(
                        samples, batch_size=8, net_h=NET, net_w=NET,
                        max_boxes=8, seed=100 + ridx, device=device)
                    keep = taylor_filter_keep_sets(
                        params, spec,
                        itertools.islice(iter(score_loader), 4), inc,
                        seen=20000, tied=tied)
                else:
                    keep = uniform_filter_fraction_keep_sets(
                        spec, params, inc, criterion=criterion, tied=tied)
                spec, params = repack(spec, params, keep)
            pruned = evaluate(params, spec, samples, names, cfg).map50
            params, loss = train_steps(spec, params, samples, round_steps,
                                       seed=2 + ridx, device=device)
            rec = evaluate(params, spec, samples, names, cfg).map50
            print(f"round {ridx}: cum {frac:.0%} filters pruned + repacked "
                  f"(params {num_params(params)/1e3:.0f}k) | "
                  f"mAP {pruned*100:5.1f} pruned -> {rec*100:5.1f} after "
                  f"{round_steps}-step fine-tune (delta vs base "
                  f"{(rec-base)*100:+.1f})", flush=True)
            rounds.append({"fraction": frac, "inc": inc,
                           "spec_before": spec_before,
                           "params_before": params_before, "keep": keep,
                           "spec": spec, "pruned": pruned, "recovered": rec,
                           "params": params})
            prev_frac = frac
    return {"base": base, "rounds": rounds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--criterion", default="l1",
                    choices=("l1", "bn_gamma", "fpgm", "taylor"))
    ap.add_argument("--family", default="v2", choices=sorted(FAMILY_CFGS))
    ap.add_argument("--tied", default="protect",
                    choices=("protect", "group"),
                    help="shortcut-tied conv policy (v3 graphs): "
                         "'group' slims the identity paths with shared "
                         "keep-sets")
    ap.add_argument("--base-steps", type=int, default=BASE_STEPS)
    ap.add_argument("--round-steps", type=int, default=ROUND_STEPS)
    ap.add_argument("--chmul", type=int, default=1,
                    help="v4 fixture channel multiplier: widens the net "
                         "so the 75%%-pruned REMNANT has capacity "
                         "comparable to the v2 fixture's (~10k params); "
                         "chmul=2 leaves ~16k at 75%%")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from modelcompression_tpu_torch.core.device import resolve_device
    run(args.family, args.criterion, args.tied, args.chmul, args.base_steps,
        args.round_steps, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
