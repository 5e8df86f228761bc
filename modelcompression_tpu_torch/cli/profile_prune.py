"""Where the magnitude mask computation's time goes on the card.

    python -m modelcompression_tpu_torch.cli.profile_prune

For YOLOv2-VOC (random init, seed 0, all 23 convs, sparsity 0.75), per
layer and global. Prints one JSON line per mode:

* ``ab_ms``: one mask computation through the top-k/mask kernels
  (``ops/cuda_topk``) and through the stable-argsort reference
  (``compress/criteria``), timed in turns (kernels, reference, reference,
  kernels, twice) with CUDA events;
* ``stages_ms``: the flat layout (HWIO flattening, concatenation, segment
  ids), the threshold by the radix select (``select``, the route
  ``prune_flat`` takes: 5 launches), the same threshold by the 31-round
  bisection through the count kernel (``bisection``, the yardstick no
  path runs), the whole ``prune_flat`` and the unflattening, each timed
  alone with CUDA events;
* ``profile``: a ``torch.profiler`` window over 3 mask computations:
  device time by kernel (top 12), device operations per computation and
  the device's busy and idle share of the wall time.

Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from modelcompression_tpu_torch.cli._profiling import (
    profile_window, time_ms,
)

SPARSITY = 0.75


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_prune: needs a CUDA device", file=sys.stderr)
        return 1
    from modelcompression_tpu_torch.compress import criteria
    from modelcompression_tpu_torch.models import (
        init_params, params_to, yolov2_voc,
    )
    from modelcompression_tpu_torch.ops import cuda_topk as ct
    from modelcompression_tpu_torch.ops import topk_mask as tm
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    spec = yolov2_voc()
    params = params_to(init_params(spec, seed=0), "cuda")
    for mode, per_layer in (("perlayer", True), ("global", False)):
        kernels = getattr(ct, f"magnitude_masks_{mode}")
        reference = getattr(criteria, f"magnitude_masks_{mode}")
        routes = {"kernels": lambda: kernels(params, spec, SPARSITY),
                  "reference": lambda: reference(params, spec, SPARSITY)}
        ab = {"kernels": [], "reference": []}
        for name in ("kernels", "reference", "reference", "kernels") * 2:
            ab[name].append(time_ms(routes[name], iters=5))
        keys, cat, sizes, seg, n_zero, S = ct._prune_layout(
            params, spec, SPARSITY, per_layer, ())
        bits = tm.abs_bits(cat)
        k = (n_zero - 1).clamp_min(0)
        stages = {
            "layout": time_ms(lambda: ct._prune_layout(
                params, spec, SPARSITY, per_layer, ()), iters=5),
            "select": time_ms(lambda: ct.radix_select(
                bits, seg, k, S), iters=5),
            "bisection": time_ms(lambda: tm.segmented_kth_bits(
                bits, seg, k, S, count_le=ct.count_le), iters=5),
            "prune_flat": time_ms(lambda: ct.prune_flat(
                cat, seg, n_zero, S, return_mask=True), iters=5),
            "unflatten": time_ms(lambda: ct._unflatten(
                params, keys, sizes, cat != 0), iters=5),
        }
        prof, _ = profile_window(routes["kernels"])
        print(json.dumps({"mode": mode, "card": card, "segments": S,
                          "ab_ms": ab, "stages_ms": stages,
                          "profile": prof}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
