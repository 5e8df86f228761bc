"""Shared CLI plumbing, the serving, pruning, evaluation and training
subset of ``modelcompression_tpu/cli/common.py``."""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from modelcompression_tpu_torch.data.voc import (
    VOC_CLASSES, load_list_dataset, load_voc_devkit, read_data_cfg,
    read_names,
)
from modelcompression_tpu_torch.models import (
    fold_batchnorm, init_params, load_cfg, load_weights, params_to,
)


def add_model_args(p: argparse.ArgumentParser, weights_required=True):
    p.add_argument("--cfg", required=True, help="Darknet .cfg file")
    p.add_argument("--strict-cfg", action="store_true",
                   help="error (instead of warn) on cfg keys the parser "
                        "does not consume (models/cfg.py audit)")
    p.add_argument("--weights", required=weights_required, default=None,
                   help="Darknet .weights file (omit for random init)")
    p.add_argument("--partial", action="store_true",
                   help="--weights is a backbone prefix (Darknet's "
                        ".conv.N convention): load the covered convs, "
                        "randomly initialize the rest")


def add_parallel_args(p: argparse.ArgumentParser):
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel size: shard the batch over this "
                        "many devices on the mesh's 'data' axis (inference: "
                        "one step per device in this process; training: "
                        "one process per device, the BN statistics and "
                        "gradients all-reduced). 0 = single-device "
                        "(default); 1 runs the data-parallel path on one "
                        "device")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: shard conv filters over "
                        "the 'model' axis (training: one process per "
                        "device of the (max(dp,1), tp) mesh, each conv "
                        "whose filter count tp divides split over the "
                        "model ranks; eval replicates the model over it)")


def build_mesh(args):
    """(mesh, tp_enabled) from --dp/--tp; (None, False) when unused.

    ``--dp N`` with N >= 1, or ``--tp`` above 1, builds a (max(dp, 1), tp)
    mesh on ``--device`` (CUDA: one visible card per device, else the JAX
    ``ValueError``). The JAX CLIs build none for ``--dp 1`` alone; here it
    runs the data-parallel path on one card, with the same results. Inside
    a rank of ``spawn_ranks`` the mesh is the one the ranks were started
    on."""
    from modelcompression_tpu_torch.core.mesh import MeshConfig, make_mesh
    from modelcompression_tpu_torch.parallel import ranks
    dp, tp = getattr(args, "dp", 0), getattr(args, "tp", 1)
    if dp < 1 and tp <= 1:
        return None, False
    config = MeshConfig(data=max(dp, 1), model=max(tp, 1))
    grid = ranks.grid()
    if grid is not None:
        if grid.mesh.shape != {"data": config.data, "model": config.model}:
            raise ValueError(f"mesh {config} differs from the ranks' mesh "
                             f"{grid.mesh.shape}")
        return grid.mesh, tp > 1
    return make_mesh(config, device=getattr(args, "device", None)), tp > 1


def spawn_ranks(args, target: str, argv):
    """The training CLIs' ``--dp`` / ``--tp``: outside a process group,
    start one rank per device of the mesh (``build_mesh``), each running
    ``target`` (the CLI's ``module:main``) on the same command line
    (``parallel/ranks.spawn``), and return the code they exit with.
    Returns None, for the caller to go on, inside a rank or without a
    mesh. Raises the JAX ``ValueError`` for a mesh wider than the
    devices."""
    from modelcompression_tpu_torch.parallel import ranks
    if ranks.grid() is not None:
        return None
    mesh, _ = build_mesh(args)
    if mesh is None:
        return None
    return ranks.spawn(target, sys.argv[1:] if argv is None else argv, mesh)


def rank_device(args, mesh):
    """The device this process trains on: its rank's on the mesh, else
    ``--device``."""
    from modelcompression_tpu_torch.core.device import resolve_device
    from modelcompression_tpu_torch.parallel import ranks
    if mesh is None:
        return resolve_device(args.device)
    return mesh.rank_devices[ranks.rank() or 0]


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--data", required=True,
                   help=".data file (train=/valid=/names=), VOCdevkit "
                        "root, or COCO instances_*.json")
    p.add_argument("--image-set", default="test",
                   help="VOCdevkit image set (when --data is a devkit root)")
    p.add_argument("--image-dir", default=None,
                   help="with a COCO --data json: image directory "
                        "(default: the standard <root>/<split>/ layout)")


def load_dataset(args):
    """(samples, class_names) from ``--data``: a VOCdevkit root, a COCO
    instances json, or a Darknet ``.data`` file (its valid= list)."""
    data = args.data
    if os.path.isdir(data):  # VOCdevkit root
        return (load_voc_devkit(data, image_set=args.image_set),
                list(VOC_CLASSES))
    if data.endswith(".json"):  # COCO instances file (one split per file)
        from modelcompression_tpu_torch.data.coco import load_coco_json
        return load_coco_json(data,
                              image_dir=getattr(args, "image_dir", None))
    cfg = read_data_cfg(data)
    names = read_names(cfg["names"]) if "names" in cfg else list(VOC_CLASSES)
    key = "valid" if "valid" in cfg else "train"
    return load_list_dataset(cfg[key]), names


def load_train_dataset(args):
    """(samples, class_names) for training: a COCO json, a VOCdevkit root
    (its ``trainval`` set unless --image-set names another than the eval
    default ``test``), or a ``.data`` file's train= list (valid= if it has
    none)."""
    data = args.data
    if data.endswith(".json"):
        from modelcompression_tpu_torch.data.coco import load_coco_json
        return load_coco_json(data,
                              image_dir=getattr(args, "image_dir", None))
    if os.path.isdir(data):
        image_set = getattr(args, "image_set", None)
        if not image_set or image_set == "test":
            image_set = "trainval"
        return (load_voc_devkit(data, image_set=image_set),
                list(VOC_CLASSES))
    cfg = read_data_cfg(data)
    names = read_names(cfg["names"]) if "names" in cfg else list(VOC_CLASSES)
    key = "train" if "train" in cfg else "valid"
    return load_list_dataset(cfg[key]), names


def resolve_batch_subdivisions(args, spec):
    """Darknet's effective-batch semantics for the train and finetune CLIs
    ([net] batch/subdivisions).

    An explicit --batch without --subdivisions is the per-update batch in
    one forward; only the cfg-default path inherits the cfg's
    subdivisions. Explicit values are tested with ``is not None``, so
    ``--batch 0`` / ``--subdivisions 0`` are rejected rather than falling
    back to the cfg.

    Returns (batch, subdivisions); raises ValueError on invalid combos.
    """
    if args.batch is not None and args.subdivisions is None:
        subdiv = 1
    elif args.subdivisions is not None:
        subdiv = args.subdivisions
    else:
        subdiv = spec.net.subdivisions
    batch = args.batch if args.batch is not None else spec.net.batch
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if subdiv < 1:
        raise ValueError(f"subdivisions must be >= 1, got {subdiv}")
    if batch % subdiv:
        raise ValueError(f"batch {batch} must be divisible by "
                         f"subdivisions {subdiv}")
    return batch, subdiv


# the measured deployment configuration of the serving headline (conf
# 0.01, K=32, class-agnostic NMS prefilter 128); --deployment applies it
DEPLOYMENT_PRESET = {"conf": 0.01, "max_detections": 32,
                     "nms_prefilter": 128}


def add_serving_nms_args(p: argparse.ArgumentParser):
    """The serving-surface NMS knobs. Defaults are None so --deployment
    can fill in the preset without clobbering explicit flags."""
    p.add_argument("--conf", type=float, default=None,
                   help="confidence threshold (default 0.25; "
                        "--deployment: 0.01)")
    p.add_argument("--nms", type=float, default=0.45, help="NMS IoU")
    p.add_argument("--max-detections", type=int, default=None,
                   help="per-class NMS output cap K (default 50; "
                        "--deployment: 32)")
    p.add_argument("--nms-prefilter", type=int, default=None,
                   help="class-agnostic top-N' candidate prefilter before "
                        "the per-class NMS sorts (0 = off, the default; "
                        "--deployment: 128)")
    p.add_argument("--nms-prefilter-impl", choices=("topk", "bisect"),
                   default="topk",
                   help="prefilter implementation: 'topk' (per-image "
                        "stable sort) or 'bisect' (sort-free batched "
                        "segmented select through the top-k kernels; "
                        "same exactness condition, evaluation/nms.py)")
    p.add_argument("--soft-nms", choices=("linear", "gaussian"),
                   default=None,
                   help="Soft-NMS score decay instead of greedy erasure "
                        "(accuracy knob for dense/overlapping scenes)")
    p.add_argument("--diou-nms", action="store_true",
                   help="DIoU-NMS: greedy suppression on IoU minus the "
                        "center-distance penalty (occluded objects). "
                        "Defaults ON when the cfg's [yolo] heads carry "
                        "nms_kind=diounms")
    p.add_argument("--diou-beta", type=float, default=None,
                   help="DIoU-NMS penalty exponent (rho^2/c^2)^beta "
                        "(darknet beta_nms; default 1.0, or the cfg's "
                        "beta_nms when nms_kind=diounms)")
    p.add_argument("--deployment", action="store_true",
                   help="apply the measured deployment configuration "
                        "(conf 0.01, K=32, NMS prefilter 128); explicit "
                        "flags still win")


def resolve_serving_eval_config(args, spec=None):
    """Serving flags -> EvalConfig. Explicit flags override the
    --deployment preset; without it the demo defaults (conf 0.25, K=50,
    prefilter off) apply.

    With ``spec``: the cfg's [yolo] ``nms_kind=diounms`` / ``beta_nms``
    keys become the NMS defaults, as in the JAX package; explicit
    --diou-nms / --diou-beta / --soft-nms flags still win."""
    from modelcompression_tpu_torch.evaluation import EvalConfig
    preset = DEPLOYMENT_PRESET if getattr(args, "deployment", False) \
        else {"conf": 0.25, "max_detections": 50, "nms_prefilter": 0}

    def pick(name):
        v = getattr(args, name, None)
        return preset[name] if v is None else v

    diou = bool(getattr(args, "diou_nms", False))
    beta = getattr(args, "diou_beta", None)
    if spec is not None and not diou and not getattr(args, "soft_nms", None):
        diou_heads = [spec.layers[i] for i in spec.head_indices()
                      if getattr(spec.layers[i], "nms_kind", "") == "diounms"]
        if diou_heads:
            diou = True
            if beta is None:
                beta = diou_heads[0].beta_nms
    return EvalConfig(conf_thresh=pick("conf"), nms_thresh=args.nms,
                      max_detections=pick("max_detections"),
                      nms_prefilter=pick("nms_prefilter"),
                      nms_prefilter_impl=getattr(args, "nms_prefilter_impl",
                                                 "topk"),
                      soft_nms=getattr(args, "soft_nms", None) or "",
                      diou_nms=diou,
                      diou_beta=1.0 if beta is None else beta,
                      device=getattr(args, "device", "cuda"))


def resolve_mask_backend(args) -> str:
    """--use-pallas is an alias for --mask-backend pallas."""
    return "pallas" if getattr(args, "use_pallas", False) \
        else args.mask_backend


def load_model(args, seed: int = 0):
    """(spec, CPU params, seen) from --cfg and --weights, or random init
    from ``seed`` when no weights are given."""
    spec = load_cfg(args.cfg, strict=getattr(args, "strict_cfg", False))
    partial = bool(getattr(args, "partial", False))
    if args.weights:
        params, seen = load_weights(args.weights, spec, partial=partial)
        if partial:
            # backbone-prefix init: covered convs from the file, the rest
            # from random init; seen restarts at 0 as in Darknet
            init = init_params(spec, seed=seed)
            n_loaded = len(params)
            params = {k: params.get(k, v) for k, v in init.items()}
            print(f"partial init: {n_loaded} convs from {args.weights}, "
                  f"{len(params) - n_loaded} randomly initialized")
            seen = 0
    else:
        params = init_params(spec, seed=seed)
        seen = 0
    return spec, params, seen


def load_serving_model(args):
    """``(spec, params, quantized)`` from ``--weights`` (or random init), a
    ``--qmodel`` int8 artifact or a ``--cmodel`` weight-sharing artifact
    (either written by either package), whose embedded architecture must
    match ``--cfg`` (``ValueError`` otherwise). ``quantized`` means params
    is the int8 pytree of ``compress.forward_quantized``, BN-folded when it
    was saved; a cmodel gives the reconstructed float32 params, served as
    ``--weights`` are."""
    if getattr(args, "qmodel", None):
        from modelcompression_tpu_torch.compress import load_qmodel
        params, spec = load_qmodel(args.qmodel, spec=load_cfg(
            args.cfg, strict=getattr(args, "strict_cfg", False)))
        return spec, params, True
    if getattr(args, "cmodel", None):
        from modelcompression_tpu_torch.compress import load_cmodel
        params, spec = load_cmodel(args.cmodel, spec=load_cfg(
            args.cfg, strict=getattr(args, "strict_cfg", False)))
        return spec, params, False
    spec, params, _ = load_model(args)
    return spec, params, False


def quantized_eval_config(cfg):
    """A copy of the EvalConfig ``cfg`` that serves an int8 pytree: its
    forward is ``compress.forward_quantized`` (its FAST default for any
    float conv of a hybrid)."""
    from modelcompression_tpu_torch.compress import forward_quantized
    return dataclasses.replace(cfg, forward_fn=forward_quantized)


def prepare_serving(spec, params, quantized: bool, cfg):
    """The serving pytree on ``cfg.device`` and the EvalConfig to serve it
    with: an int8 pytree as it is, with ``quantized_eval_config(cfg)``;
    f32 params BN-folded, with ``cfg`` itself."""
    from modelcompression_tpu_torch.core.device import resolve_device
    device = resolve_device(cfg.device)
    if quantized:
        return params_to(params, device), quantized_eval_config(cfg)
    return params_to(fold_batchnorm(params, spec), device), cfg


def dispatch_padded_batch(step, params, canvases, ws, hs, batch: int):
    """Run the serving step on a host-side gather, padded to the fixed
    batch size by repeating the last entry (padded rows are never read
    back per image). Returns the step's device outputs (boxes, scores,
    valid) without waiting for the device: CUDA work is asynchronous, and
    ``fetch_batch`` synchronizes when the results are copied to the host."""
    canvases, ws, hs = list(canvases), list(ws), list(hs)
    while len(canvases) < batch:
        canvases.append(canvases[-1])
        ws.append(ws[-1])
        hs.append(hs[-1])
    imgs = torch.from_numpy(np.stack(canvases))
    sel, sc, valid, _, _ = step(params, imgs,
                                torch.tensor(ws, dtype=torch.float32),
                                torch.tensor(hs, dtype=torch.float32))
    return sel, sc, valid


def fetch_batch(dev_outs):
    """Copy a ``dispatch_padded_batch`` result to host numpy (waits for the
    device)."""
    return tuple(a.cpu().numpy() for a in dev_outs)


def run_padded_batch(step, params, canvases, ws, hs, batch: int):
    """dispatch_padded_batch + fetch_batch in one call."""
    return fetch_batch(dispatch_padded_batch(step, params, canvases, ws, hs,
                                             batch))


def unpack_detections(sel, scores, valid, w, h):
    """One image's padded-NMS output ``(C, K, 4)`` -> list of detection
    dicts in source-image pixels, boxes clipped to the image, sorted by
    score descending."""
    dets = []
    for ci in range(sel.shape[0]):
        for k in np.nonzero(valid[ci])[0]:
            x1, y1, x2, y2 = (float(np.clip(v, 0, lim)) for v, lim in
                              zip(sel[ci, k], (w, h, w, h)))
            dets.append({"class_id": int(ci),
                         "score": float(scores[ci, k]),
                         "box": [x1, y1, x2, y2]})
    dets.sort(key=lambda d: -d["score"])
    return dets


def prep_calibration(spec, samples, n_images: int, selector: str,
                     letterbox: bool = True, what: str = "int8"):
    """The eval and finetune CLIs' calibration plumbing: resolve and
    validate the conv-layer selector before any host work, then prepare
    the first ``n_images`` images as float [0, 1] NHWC chunks of exactly
    8 (a tail chunk is filled by cycling its own images: absmax is
    unchanged by duplicates, a quantile sees at most 7).

    Returns ``(int8_sel, chunks, n_images_used)``; raises ValueError on a
    malformed selector or indices that are not convs."""
    from modelcompression_tpu_torch.compress.quantize import (
        _resolve_int8_set, resolve_int8_layers,
    )
    from modelcompression_tpu_torch.evaluation.pipeline import _prep_batch
    try:
        int8_sel = resolve_int8_layers(spec, selector)
    except ValueError as e:
        raise ValueError(
            f"bad --{what}-layers selector {selector!r}: {e}") from e
    _resolve_int8_set(spec, int8_sel)
    n = max(1, min(n_images, len(samples)))
    batch, _, _ = _prep_batch(samples[:n], spec.net.height, spec.net.width,
                              letterbox=letterbox)
    chunks = []
    for i in range(0, batch.shape[0], 8):
        ch = batch[i:i + 8]
        if ch.shape[0] < 8:
            reps = -(-8 // ch.shape[0])
            ch = np.concatenate([ch] * reps, axis=0)[:8]
        chunks.append(ch.astype(np.float32) / 255.0)
    return int8_sel, chunks, n
