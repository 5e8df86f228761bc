"""The fixture sweeps and the sensitivity scan at the tools' own step
counts and sizes, each timed: the tables ``PERF.md`` records beside the
JAX package's CPU tables (``docs/PERF.md``, "Sparsity sweep on the fixture
task" onwards).

    python -m modelcompression_tpu_torch.tools.fixture_tables \\
        [--device cuda|cpu]

Runs, in order: ``magnitude`` (sweep_fixture
--criterion magnitude), ``v2`` (sweep_l1_iterative --family v2), ``v4``
(--family v4 --chmul 2), ``taylor`` (--criterion taylor) and
``sensitivity`` (sensitivity_scan over all 22 prunable convs of
YOLOv2-VOC 416 at 0.25 / 0.5 / 0.75, random weights from seed 0 written
through the codec, on a 160-image 416x416 fixture at batch 64). The first
line is the card's name and power limit (``cpu`` on the CPU); after each
run a line ``# <name>: <seconds> s wall``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

RUNS = ("magnitude", "v2", "v4", "taylor", "sensitivity")
SCAN_IMAGES = 160
SCAN_BATCH = 64


def _sensitivity(device: str) -> int:
    from modelcompression_tpu_torch.data import VOC_CLASSES, make_fake_voc
    from modelcompression_tpu_torch.models import (
        cfg_path, init_params, load_cfg, save_weights,
    )
    from modelcompression_tpu_torch.tools import sensitivity_scan
    cfg = cfg_path("yolov2-voc.cfg")
    spec = load_cfg(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "yolov2-voc.weights")
        save_weights(weights, spec, init_params(spec, seed=0))
        data = make_fake_voc(os.path.join(tmp, "voc"), n_images=SCAN_IMAGES,
                             image_size=spec.net.width, seed=0,
                             classes=VOC_CLASSES)
        return sensitivity_scan.main(
            ["--cfg", cfg, "--weights", weights, "--data", data, "--batch",
             str(SCAN_BATCH), "--device", device])


def run_one(name: str, device: str) -> int:
    from modelcompression_tpu_torch.tools import (
        sweep_fixture, sweep_l1_iterative,
    )
    dev = ["--device", device]
    if name == "magnitude":
        return sweep_fixture.main(["--criterion", "magnitude"] + dev)
    if name == "v2":
        return sweep_l1_iterative.main(["--family", "v2"] + dev)
    if name == "v4":
        return sweep_l1_iterative.main(["--family", "v4", "--chmul", "2"]
                                       + dev)
    if name == "taylor":
        return sweep_l1_iterative.main(["--criterion", "taylor"] + dev)
    return _sensitivity(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from modelcompression_tpu_torch.core.device import resolve_device
    from modelcompression_tpu_torch.utils.perf_ledger import device_tag
    device = resolve_device(args.device)
    print(device_tag() if device.type == "cuda" else "cpu", flush=True)
    for name in RUNS:
        t0 = time.perf_counter()
        rc = run_one(name, device.type)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s wall", flush=True)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
