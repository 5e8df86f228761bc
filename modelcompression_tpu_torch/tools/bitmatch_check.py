"""Bit-match mode evidence: run the SAME fixed-weight model and inputs
through the BITMATCH eval program (fp32, TF32 off) on the CPU and on
``--device``, and report how close the raw feature maps, the decoded
detections and the mAP are.

    python -m modelcompression_tpu_torch.tools.bitmatch_check \\
        [--device cuda|cpu]

The model is the 3-class tiny region fixture at 128x128 (random init,
seed 0); the raw maps are of 4 random uint8 frames, the mAP of the
8-image 160x160 fixture. Both run the eval program as it serves: BN
folded, conv 0 + pool through ``ops/input_stage`` (the fp32 CUDA-core
kernel on the card, its plain version on the CPU). The card's fp32
convolutions sum in another order than the CPU's, so the gap is measured,
not assumed zero.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

NET = 128


def _detection_gap(cpu, dev, names):
    """(count mismatch, max score diff, max box diff in px) between two
    {class: [Detection]} maps, detections paired in (image, -score)
    order."""
    max_box = max_score = 0.0
    mismatched = 0
    for cname in names:
        a = sorted(cpu[cname], key=lambda d: (d.image_id, -d.score))
        b = sorted(dev[cname], key=lambda d: (d.image_id, -d.score))
        if len(a) != len(b):
            mismatched += abs(len(a) - len(b))
            continue
        for da, db in zip(a, b):
            max_score = max(max_score, abs(da.score - db.score))
            max_box = max(max_box, max(abs(x - y) for x, y in
                                       zip(da.box, db.box)))
    return mismatched, max_score, max_box


def run(device) -> dict:
    """The check; prints the JAX tool's lines and returns
    the numbers: raw-map ``bit_equal``, ``max_abs``, ``max_rel``; each
    side's ``map50`` and detection count; the detections' ``mismatched``
    count, ``max_score_diff`` and ``max_box_diff``."""
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.data.fixtures import (
        FIXTURE_CLASSES, make_fake_voc, tiny_region_cfg,
    )
    from modelcompression_tpu_torch.data.voc import (
        load_list_dataset, read_data_cfg,
    )
    from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
    from modelcompression_tpu_torch.models import (
        fold_batchnorm, forward_folded, init_params, params_to, parse_cfg,
    )
    from modelcompression_tpu_torch.ops import input_stage_match

    device = torch.device(device)
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=NET, height=NET))
    params = init_params(spec, seed=0)
    images = np.random.default_rng(0).integers(0, 255, (4, NET, NET, 3),
                                               np.uint8)
    folded = fold_batchnorm(params, spec)
    fuse = input_stage_match(spec)
    BITMATCH.apply_backend_flags()

    def run_fwd(dev):
        x = torch.as_tensor(images, device=dev).float() / 255.0
        with torch.inference_mode():
            y = forward_folded(params_to(folded, dev), x, spec, BITMATCH,
                               fuse_input_stage=fuse)
        return y.cpu().numpy()

    raw_cpu, raw_dev = run_fwd("cpu"), run_fwd(device)
    diff = np.abs(raw_cpu - raw_dev)
    r = {"bit_equal": bool(np.array_equal(raw_cpu, raw_dev)),
         "max_abs": float(diff.max()),
         "max_rel": float(diff.max() / (np.abs(raw_cpu).max() + 1e-12))}
    print(f"raw feature map: bit-equal={r['bit_equal']}  max abs diff="
        f"{r['max_abs']:.3e}  max rel={r['max_rel']:.3e}")

    names = list(FIXTURE_CLASSES)
    with tempfile.TemporaryDirectory() as td:
        data_cfg = make_fake_voc(td, n_images=8, image_size=160, seed=0)
        samples = load_list_dataset(read_data_cfg(data_cfg)["valid"])
        # conf low enough that the random-weight net produces detections,
        # so the comparison exercises decode+NMS+mapping, not just zeros
        results = {}
        for name, dev in (("cpu", torch.device("cpu")), ("device", device)):
            cfg = EvalConfig(batch_size=4, precision=BITMATCH,
                             max_detections=20, conf_thresh=1e-4,
                             device=dev.type)
            res = evaluate(params, spec, samples, names, cfg)
            results[name] = res
            n_dets = sum(len(v) for v in res.detections.values())
            r[f"{name}_map50"], r[f"{name}_detections"] = res.map50, n_dets
            print(f"{name if name == 'cpu' else device.type}: mAP@50 = "
                f"{res.map50:.6f}  ({n_dets} detections)")
    r["map_delta"] = abs(r["cpu_map50"] - r["device_map50"])
    print(f"mAP delta cpu vs {device.type}: {r['map_delta']:.2e}")
    r["mismatched"], r["max_score_diff"], r["max_box_diff"] = \
        _detection_gap(results["cpu"].detections,
                       results["device"].detections, names)
    print(f"detections: count mismatch={r['mismatched']}, "
        f"max score diff={r['max_score_diff']:.3e}, "
        f"max box diff={r['max_box_diff']:.3e} px")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from modelcompression_tpu_torch.core.device import resolve_device
    run(resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
