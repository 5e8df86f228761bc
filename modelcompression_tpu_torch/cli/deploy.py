"""Deploy CLI, port of ``modelcompression_tpu/cli/deploy.py``: the full
compression recipe as one command — iterative structured prune +
(optionally distilled) fine-tune, quantization-aware int8 fine-tune with
its artifact, and the entropy-packed weight-sharing artifact — with an
mAP@50 measurement after every stage and a machine-readable report.

The stages run the port's own CLIs (finetune --iterate, finetune --qat
--save-qmodel, eval --cluster-bits --save-cmodel --pack, export), so a
deploy run behaves as the manual recipe does; this CLI sequences them,
measures, and writes <out-dir>/report.json with the JAX CLI's keys. Each
stage's checkpoints live under <out-dir>, and --resume continues an
interrupted prune schedule. Everything runs on --device (default cuda; a
missing CUDA device is an error).

Example:
  python -m modelcompression_tpu_torch.cli.deploy --cfg yolov2-voc.cfg \\
      --weights yolov2.weights --data voc.data --out-dir artifacts/ \\
      --fractions 0.25,0.5,0.75 --steps 4000 --distill --qat-steps 2000

Produces in artifacts/:
  slim.weights + slim.cfg    pruned+fine-tuned dense model
  slim-qat.weights           QAT-recovered f32 twin of the int8 grids
  deploy.qz                  int8 serving artifact (eval/detect --qmodel)
  deploy.cz                  packed weight-sharing artifact (--cmodel)
  saved_model.pt2            with --export saved_model: the serving step
                             as a torch.export program (cli/export.py)
  report.json                per-stage mAP@50, params, artifact bytes
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from modelcompression_tpu_torch.cli import eval as eval_cli
from modelcompression_tpu_torch.cli import export as export_cli
from modelcompression_tpu_torch.cli import finetune as finetune_cli
from modelcompression_tpu_torch.cli.common import (
    load_dataset, load_serving_model, prepare_serving,
)
from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
from modelcompression_tpu_torch.models import num_params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deploy", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", required=True, help="Darknet .cfg file")
    p.add_argument("--weights", required=True, help="trained .weights")
    p.add_argument("--data", required=True,
                   help="dataset (.data file or VOCdevkit root); train "
                        "split drives fine-tune, eval split the stage "
                        "measurements")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device every stage runs on (default cuda; a "
                        "missing CUDA device is an error)")
    p.add_argument("--fractions", default="0.25,0.5,0.75",
                   help="cumulative structured-prune schedule")
    p.add_argument("--tied", default="protect",
                   choices=("protect", "group"),
                   help="residual-graph policy for the structured prune "
                        "stage (finetune --tied): 'group' slims "
                        "shortcut-tied identity paths with one shared "
                        "keep-set per group")
    p.add_argument("--iterate-mode", default="l1_filter",
                   choices=("l1_filter", "bn_gamma", "taylor"))
    p.add_argument("--steps", type=int, default=1000,
                   help="fine-tune steps per prune round")
    p.add_argument("--distill", action="store_true",
                   help="distill each round's fine-tune from the ORIGINAL "
                        "--weights teacher")
    p.add_argument("--qat-steps", type=int, default=500,
                   help="quantization-aware fine-tune steps on the slimmed "
                        "model; 0 skips the int8 stage")
    p.add_argument("--int8-layers", default="auto:64",
                   help="conv subset for the int8 hybrid (the measured "
                        "pruned-serving default; 'all' for unpruned)")
    p.add_argument("--cluster-bits", type=int, default=6,
                   help="weight-sharing artifact codebook bits; 0 skips")
    p.add_argument("--pack", default="huffman",
                   choices=("huffman", "fixed", "none"),
                   help="entropy-pack the weight-sharing artifact")
    p.add_argument("--export", default="none",
                   choices=("none", "saved_model", "tflite", "both"),
                   help="stage 4: also export the serving step; "
                        "'saved_model' writes the torch.export program "
                        "(saved_model.pt2, cli/export.py) of the slimmed "
                        "f32 weights — QAT'd if stage 2 ran. 'tflite' and "
                        "'both' have no PyTorch form and exit 2")
    p.add_argument("--batch", type=int, default=None,
                   help="training batch override (default: the cfg's)")
    p.add_argument("--eval-batch", type=int, default=8,
                   help="stage-measurement eval batch size")
    p.add_argument("--image-set", default="test",
                   help="VOCdevkit image set for stage measurements")
    p.add_argument("--max-boxes", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted prune schedule from "
                        "<out-dir>/ckpt")
    return p


def _measure(cfg_path: str, data: str, image_set: str, batch: int,
             device: str, weights: str = None, qmodel: str = None):
    """mAP@50 + params for one stage, through the serving loaders and the
    eval engine the eval CLI uses."""
    a = argparse.Namespace(cfg=cfg_path, weights=weights, qmodel=qmodel,
                           cmodel=None, partial=False, data=data,
                           image_set=image_set)
    spec, params, quantized = load_serving_model(a)
    samples, names = load_dataset(a)
    cfg = EvalConfig(batch_size=batch, device=device)
    if quantized:
        # evaluate() BN-folds f32 params itself; only the int8 pytree
        # needs the serving set-up here
        params, cfg = prepare_serving(spec, params, True, cfg)
    res = evaluate(params, spec, samples, names, cfg)
    return {"map50": round(res.map50 * 100, 2),
            "params": num_params(params)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for frac in args.fractions.split(","):
        try:
            ok = not frac or 0.0 <= float(frac) < 1.0
        except ValueError:
            ok = False
        if not ok:
            print(f"error: bad fraction {frac!r} (need a number in "
                  f"[0, 1))", file=sys.stderr)
            return 2
    if args.export in ("tflite", "both"):
        print(f"error: --export {args.export} has no PyTorch form (no "
              f"TensorFlow Lite converter ships with PyTorch); use "
              f"--export saved_model", file=sys.stderr)
        return 2
    resolve_device(args.device)  # no CUDA: raise before any stage
    os.makedirs(args.out_dir, exist_ok=True)
    out = lambda name: os.path.join(args.out_dir, name)  # noqa: E731
    report = {"stages": {}, "artifacts": {}}
    t0 = time.time()
    dev = ["--device", args.device]

    def batch_args():
        return ["--batch", str(args.batch)] if args.batch else []

    def measure(cfg_path, **src):
        return _measure(cfg_path, args.data, args.image_set,
                        args.eval_batch, args.device, **src)

    # stage 0: baseline
    print("== stage 0: baseline eval ==")
    report["stages"]["baseline"] = measure(args.cfg, weights=args.weights)
    print(f"baseline: {report['stages']['baseline']}")

    # stage 1: iterative structured prune + fine-tune (+ distill)
    print(f"== stage 1: iterative {args.iterate_mode} prune "
          f"{args.fractions} ({args.steps} steps/round"
          + (", distilled" if args.distill else "") + ") ==")
    slim_w, slim_cfg = out("slim.weights"), out("slim.cfg")
    ft = ["--cfg", args.cfg, "--weights", args.weights,
          "--data", args.data, "--steps", str(args.steps),
          "--iterate", args.fractions, "--iterate-mode", args.iterate_mode,
          "--max-boxes", str(args.max_boxes), "--seed", str(args.seed),
          "--ckpt-dir", out("ckpt"), "--out", slim_w,
          "--out-cfg", slim_cfg, "--tied", args.tied] + batch_args() + dev
    if args.distill:
        ft += ["--distill", args.weights]
    if args.resume:
        ft += ["--resume"]
    if (rc := finetune_cli.main(ft)) != 0:
        return rc
    report["stages"]["pruned"] = measure(slim_cfg, weights=slim_w)
    report["artifacts"]["slim.weights"] = os.path.getsize(slim_w)
    print(f"pruned: {report['stages']['pruned']}")

    # stage 2: QAT int8 + serving artifact
    qz = out("deploy.qz")
    if args.qat_steps > 0:
        print(f"== stage 2: QAT int8 ({args.qat_steps} steps, "
              f"layers {args.int8_layers}) ==")
        ft = ["--cfg", slim_cfg, "--weights", slim_w, "--data", args.data,
              "--steps", str(args.qat_steps), "--qat",
              "--qat-layers", args.int8_layers,
              "--max-boxes", str(args.max_boxes), "--seed", str(args.seed),
              "--save-qmodel", qz,
              "--out", out("slim-qat.weights")] + batch_args() + dev
        if (rc := finetune_cli.main(ft)) != 0:
            return rc
        report["stages"]["int8"] = measure(slim_cfg, qmodel=qz)
        report["artifacts"]["deploy.qz"] = os.path.getsize(qz)
        print(f"int8: {report['stages']['int8']}")

    # stage 3: packed weight-sharing artifact (its mAP is measured by the
    # eval CLI run that writes it)
    if args.cluster_bits > 0:
        print(f"== stage 3: {args.cluster_bits}-bit weight sharing"
              + (f" + {args.pack} packing" if args.pack != "none" else "")
              + " ==")
        cz = out("deploy.cz")
        ev = ["--cfg", slim_cfg, "--weights", slim_w, "--data", args.data,
              "--batch", str(args.eval_batch),
              "--image-set", args.image_set,
              "--cluster-bits", str(args.cluster_bits),
              "--save-cmodel", cz] + dev
        if args.pack != "none":
            ev += ["--pack", args.pack]
        if (rc := eval_cli.main(ev)) != 0:
            return rc
        report["artifacts"]["deploy.cz"] = os.path.getsize(cz)

    # stage 4: the serving step of the slimmed f32 weights (QAT'd if stage
    # 2 ran) as a torch.export program, verified against the live step
    if args.export == "saved_model":
        src_w = (out("slim-qat.weights") if args.qat_steps > 0 else slim_w)
        print(f"== stage 4: export ({args.export}) ==")
        sm = out("saved_model.pt2")
        if (rc := export_cli.main(
                ["--cfg", slim_cfg, "--weights", src_w, "--out", sm,
                 "--batch", "1", "--platforms", args.device])) != 0:
            return rc
        report["artifacts"]["saved_model"] = os.path.getsize(sm)

    report["wall_s"] = round(time.time() - t0, 1)
    with open(out("report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    print(f"wrote {out('report.json')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
