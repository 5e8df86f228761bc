"""Config-2 sweep shape (BASELINE.json:8) on the learnable fixture: train
to high mAP, then unstructured prune at 50/75/90% and measure mAP@50
before and after a short masked fine-tune at each sparsity.
``--criterion magnitude`` (per-layer, the default) | ``global`` | ``lamp``.

    python -m modelcompression_tpu_torch.tools.sweep_fixture \\
        [--criterion magnitude|global|lamp] [--device cuda|cpu]

The masks come from ``ops/cuda_topk`` (magnitude, global) and
``compress/lamp`` (LAMP's global cut through ``prune_flat``): the top-k
kernels on the card, their plain versions on the CPU. ``main`` takes the
step counts as keyword arguments (default: the JAX tool's 600 base and
200 fine-tune steps) so that a smoke run can cut them.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from modelcompression_tpu_torch.compress.lamp import lamp_masks
from modelcompression_tpu_torch.ops import cuda_topk

# {criterion: fn(params, spec, sparsity) -> bool OIHW keep-masks}
MASK_FNS = {"magnitude": cuda_topk.magnitude_masks_perlayer,
            "global": cuda_topk.magnitude_masks_global,
            "lamp": lamp_masks}
BASE_STEPS = 600
TUNE_STEPS = 200
SPARSITIES = (0.5, 0.75, 0.9)
NET = 96
EVAL = dict(batch_size=8, conf_thresh=0.005, max_detections=20)


def fixture(root: str):
    """(samples, spec, class names): the 16-image 96x96 fixture task and
    its 3-class tiny region net."""
    from modelcompression_tpu_torch.data.fixtures import (
        FIXTURE_CLASSES, make_fake_voc, tiny_region_cfg,
    )
    from modelcompression_tpu_torch.data.voc import (
        load_list_dataset, read_data_cfg,
    )
    from modelcompression_tpu_torch.models import parse_cfg
    data_cfg = make_fake_voc(root, n_images=16, image_size=NET, seed=0)
    samples = load_list_dataset(read_data_cfg(data_cfg)["valid"])
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=NET, height=NET))
    return samples, spec, list(FIXTURE_CLASSES)


def train_steps(spec, params, samples, n, seed, device, masks=None):
    """``n`` steps of the fixture fine-tune (batch 8, no flip or jitter)
    from ``params``; returns (params, last loss or None)."""
    from modelcompression_tpu_torch.train import (
        BatchLoader, TrainConfig, TrainState, make_optimizer,
        make_train_step,
    )
    config = TrainConfig.from_spec(spec, augment_flip=False,
                                   augment_jitter=0.0, max_boxes=8)
    loader = BatchLoader(samples, batch_size=8, net_h=NET, net_w=NET,
                         max_boxes=8, seed=seed, device=device)
    state = TrainState.create(params, make_optimizer(config),
                              torch.Generator().manual_seed(seed),
                              weight_masks=masks or {})
    step = make_train_step(spec, config)
    it = iter(loader)
    m = None
    for _ in range(n):
        imgs, tgts = next(it)
        state, m = step(state, imgs, tgts)
    params = {k: {n_: v.detach() for n_, v in p.items()}
              for k, p in state["params"].items()}
    return params, (None if m is None else float(m["loss"]))


def run(criterion: str, device, base_steps: int = BASE_STEPS,
        tune_steps: int = TUNE_STEPS):
    """The sweep. Prints the JAX tool's lines and returns {"spec",
    "params" (the trained base), "base" mAP, "rows": [{sparsity, achieved,
    masks, pruned, tuned} per sparsity]}."""
    from modelcompression_tpu_torch.compress import (
        apply_masks, mask_sparsity,
    )
    from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
    from modelcompression_tpu_torch.models import init_params, params_to
    device = torch.device(device)
    cfg = EvalConfig(device=device.type, **EVAL)
    mask_fn = MASK_FNS[criterion]
    with tempfile.TemporaryDirectory() as td:
        samples, spec, names = fixture(td)
        params, _ = train_steps(
            spec, params_to(init_params(spec, seed=0), device), samples,
            base_steps, seed=1, device=device)
        base = evaluate(params, spec, samples, names, cfg).map50
        print(f"criterion: {criterion}")
        print(f"baseline mAP@50: {base*100:.1f}")
        rows = []
        for s in SPARSITIES:
            with torch.no_grad():
                masks = mask_fn(params, spec, s)
            ach = float(mask_sparsity(masks))
            pruned = apply_masks(params, masks)
            m0 = evaluate(pruned, spec, samples, names, cfg).map50
            tuned, _ = train_steps(spec, pruned, samples, tune_steps,
                                   seed=int(s * 100), device=device,
                                   masks=masks)
            m1 = evaluate(tuned, spec, samples, names, cfg).map50
            print(f"sparsity {s:.0%} (achieved {ach:.1%}): "
                  f"pruned {m0*100:.1f} -> finetuned {m1*100:.1f} "
                  f"(delta vs base {100*(m1-base):+.1f})", flush=True)
            rows.append({"sparsity": s, "achieved": ach, "masks": masks,
                         "pruned": m0, "tuned": m1})
    return {"spec": spec, "params": params, "base": base, "rows": rows}


def main(argv=None, base_steps: int = BASE_STEPS,
         tune_steps: int = TUNE_STEPS) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--criterion", default="magnitude",
                    choices=tuple(MASK_FNS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from modelcompression_tpu_torch.core.device import resolve_device
    run(args.criterion, resolve_device(args.device), base_steps, tune_steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
