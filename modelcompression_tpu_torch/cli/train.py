"""Train CLI, port of ``modelcompression_tpu/cli/train.py``: full training
from random init (or a ``--partial`` backbone) on --device (default cuda;
a missing CUDA device is an error). Hyper-parameters default to the cfg's
[net] section; multi-scale training defaults to the head's ``random=``.
``--checkpoint-dir`` saves the train state every --checkpoint-every steps
and at the end; ``--resume`` restores the latest one and fast-forwards the
data stream, so the run continues as an uninterrupted one would.

``--dp N`` and ``--tp M`` train over a (max(N, 1), M) mesh of --device,
one process per device (as ``finetune --dp / --tp``): the batch split
over the data axis, the conv filters over the model axis; rank 0 alone
logs, evaluates and checkpoints (the params gathered whole on every rank
first).

Example:
  python -m modelcompression_tpu_torch.cli.train --cfg tiny-yolo-voc.cfg \\
      --data voc.data --steps 2000 --checkpoint-dir ckpts/ --eval-every 500
"""

from __future__ import annotations

import argparse
import sys

import torch

from modelcompression_tpu_torch.cli.common import (
    add_data_args, add_model_args, add_parallel_args, build_mesh,
    load_dataset, load_model, load_train_dataset, rank_device,
    resolve_batch_subdivisions, spawn_ranks,
)
from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
from modelcompression_tpu_torch.models import dump_cfg, params_to
from modelcompression_tpu_torch.models.cfg import ConvLayer
from modelcompression_tpu_torch.parallel.ranks import is_primary
from modelcompression_tpu_torch.parallel.sharding import gather_train_state
from modelcompression_tpu_torch.train import (
    BatchLoader, TrainConfig, TrainState, make_optimizer, train,
)
from modelcompression_tpu_torch.utils.checkpoint import (
    latest_checkpoint, load_checkpoint, save_checkpoint,
)
from modelcompression_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p, weights_required=False)
    add_data_args(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the model trains on (default cuda; a "
                        "missing CUDA device is an error)")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--batch", type=int, default=None,
                   help="EFFECTIVE batch per weight update "
                        "(default: cfg batch=)")
    p.add_argument("--subdivisions", type=int, default=None,
                   help="micro-batches accumulated per update (default: "
                        "cfg subdivisions=); 1 runs the whole batch in one "
                        "forward")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--max-boxes", type=int, default=30)
    p.add_argument("--bn-l1", type=float, default=0.0,
                   help="network-slimming L1 penalty on all BN gammas; "
                        "0 = off")
    p.add_argument("--freeze", type=int, default=0, metavar="N",
                   help="freeze the first N conv layers (Darknet .conv.N "
                        "counting; pairs with --partial backbone files)")
    p.add_argument("--mosaic", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="4-image mosaic augmentation. Default: the "
                        "cfg's [net] mosaic= flag")
    p.add_argument("--hsv", action="store_true")
    p.add_argument("--jitter", type=float, default=None,
                   help="Darknet crop-jitter fraction in [0, 0.5); "
                        "default: the cfg's [region] jitter value; "
                        "pass 0 to disable")
    p.add_argument("--multi-scale", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Darknet random-resize training (cfg random=1): "
                        "redraw the net size from 320..608 every 10 "
                        "batches. Default: the cfg's random= flag")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from "
                        "--checkpoint-dir (params, momentum, step/seen, "
                        "generator) and continue until --steps TOTAL "
                        "steps; the data stream is fast-forwarded")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--log-jsonl", default=None)
    p.add_argument("--seed", type=int, default=0)
    add_parallel_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        rc = spawn_ranks(args, "modelcompression_tpu_torch.cli.train:main",
                         argv)
        mesh = build_mesh(args)[0]
    except ValueError as e:  # a mesh wider than the devices
        print(f"error: {e}", file=sys.stderr)
        return 2
    if rc is not None:  # --dp / --tp: the ranks ran this CLI
        return rc
    device = rank_device(args, mesh)  # no CUDA: raise before reading
    spec, params, seen = load_model(args, seed=args.seed)
    samples, names = load_train_dataset(args)
    if not samples:
        print("error: dataset is empty", file=sys.stderr)
        return 2

    overrides = {}
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    n_convs = sum(1 for l in spec.layers if isinstance(l, ConvLayer))
    if not 0 <= args.freeze < n_convs:
        print(f"error: --freeze {args.freeze} must leave at least one "
              f"trainable conv (network has {n_convs})", file=sys.stderr)
        return 2
    head0 = spec.layers[spec.head_indices()[0]]  # [region] or first [yolo]
    jitter = args.jitter if args.jitter is not None else head0.jitter
    if not 0.0 <= jitter < 0.5:
        print(f"error: --jitter must be in [0, 0.5), got {jitter}",
              file=sys.stderr)
        return 2
    try:
        batch, subdiv = resolve_batch_subdivisions(args, spec)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    mosaic = args.mosaic if args.mosaic is not None else spec.net.mosaic
    config = TrainConfig.from_spec(
        spec, augment_mosaic=mosaic, augment_hsv=args.hsv,
        augment_jitter=jitter, subdivisions=subdiv,
        max_boxes=args.max_boxes, bn_l1=args.bn_l1,
        freeze_prefix=args.freeze, **overrides)
    # the head's random flag turns multi-scale on; the band is the [yolo]
    # resize= multiplier around the net WIDTH when the cfg has one (as the
    # JAX CLI: width only), else the classic 320..608
    use_ms = (args.multi_scale if args.multi_scale is not None
              else head0.random)
    rs = getattr(head0, "resize", 1.0)
    if use_ms and rs > 1.0:
        lo = max(32, int(spec.net.width / rs) // 32 * 32)
        hi = max(lo + 32, -(-int(spec.net.width * rs) // 32) * 32)
        multi_scale = (lo, hi)
    elif use_ms:
        multi_scale = (320, 608)
    else:
        multi_scale = None
    loader = BatchLoader(samples, batch_size=batch,
                         net_h=spec.net.height, net_w=spec.net.width,
                         max_boxes=args.max_boxes, seed=args.seed,
                         multi_scale=multi_scale, device=device)
    state = TrainState.create(params_to(params, device),
                              make_optimizer(config),
                              torch.Generator().manual_seed(args.seed),
                              seen=seen)
    n_steps = args.steps
    start = 0
    if args.resume:
        if not args.checkpoint_dir:
            print("error: --resume requires --checkpoint-dir",
                  file=sys.stderr)
            return 2
        latest = latest_checkpoint(args.checkpoint_dir)
        if latest is None:
            print(f"no checkpoint in {args.checkpoint_dir}; starting fresh")
        else:
            # restore INTO the fresh state (params in place, the optimizer's
            # momentum, the generator state, the counters)
            ck_spec, state, _ = load_checkpoint(latest, target=state)
            if dump_cfg(ck_spec) != dump_cfg(spec):
                print(f"error: checkpoint architecture ({latest}/arch.cfg)"
                      f" differs from --cfg {args.cfg} — resume must "
                      "continue the same run", file=sys.stderr)
                return 2
            start = state["step"]
            n_steps = args.steps - start
            if n_steps <= 0:
                print(f"nothing to do: checkpoint at step {start} >= "
                      f"--steps {args.steps}")
                return 0
            # replay the data stream to where the interrupted run stood
            loader.skip_batches(start)
            print(f"resumed {latest} at step {start} "
                  f"(seen {state['seen']}); {n_steps} steps to go")
    logger = MetricsLogger(jsonl_path=args.log_jsonl if is_primary()
                           else None)
    if mesh is not None and (batch // subdiv) % mesh.shape["data"]:
        print(f"error: micro-batch {batch // subdiv} (batch/subdivisions) "
              f"must be divisible by --dp {mesh.shape['data']}",
              file=sys.stderr)
        return 2

    # rank 0 alone evaluates and checkpoints; every rank takes the calls,
    # as tensor parallelism gathers the params whole for them
    eval_fn = None
    if args.eval_every:
        if is_primary():
            eval_samples, eval_names = load_dataset(args)
            eval_cfg = EvalConfig(batch_size=batch, device=args.device)

        def eval_fn(p):
            if not is_primary():
                return {}
            res = evaluate(p, spec, eval_samples, eval_names, eval_cfg)
            return {"map50": res.map50, "img_per_sec": res.images_per_sec}

    ckpt_fn = None
    if args.checkpoint_dir:
        def ckpt_fn(step, st):
            if is_primary():
                # named by the GLOBAL step, so a resumed run extends the
                # directory instead of overwriting step_00000001 onward
                d = save_checkpoint(args.checkpoint_dir, st["step"], spec,
                                    st)
                print(f"checkpoint -> {d}")

    state = train(state, spec, config, loader, n_steps=n_steps,
                  logger=logger, eval_fn=eval_fn,
                  eval_every=args.eval_every, checkpoint_fn=ckpt_fn,
                  checkpoint_every=args.checkpoint_every,
                  initial_step=start, mesh=mesh)
    if args.checkpoint_dir:
        state = gather_train_state(state, mesh, spec)
        if is_primary():
            d = save_checkpoint(args.checkpoint_dir, state["step"], spec,
                                state)
            print(f"final checkpoint -> {d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
