"""End-to-end evaluation (port of ``modelcompression_tpu/evaluation/
pipeline.py``): the fused serving step

  [letterbox ->] normalize -> conv stack -> [region] / [yolo] decode ->
  per-class NMS (any variant of ``nms.py``) -> boxes in source-image pixels

and ``evaluate``, which feeds a dataset through it and scores the
detections with the VOC AP protocol (``voc_map.py``).

One step per (spec, config, src_hw). The host feeds fixed-size uint8
batches plus per-image (w, h) and collects the small post-NMS outputs.
Two ingestion modes, as in the JAX package:

* ``src_hw=None``: canvases were letterboxed on the host to the net size;
  the step starts at normalize.
* ``src_hw=(H, W)``: fixed-size source frames; the letterbox runs on the
  device inside the step.

PyTorch runs eagerly, so there is no compile step; the step runs under
``torch.inference_mode`` on ``config.device``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.core.precision import FAST, Precision
from modelcompression_tpu_torch.data.preprocess import (
    letterbox_device, letterbox_host, quantize_canvas, resize_host,
    stretch_resize_device,
)
from modelcompression_tpu_torch.data.streaming import (
    prefetch_to_device, to_device,
)
from modelcompression_tpu_torch.data.voc import Sample
from modelcompression_tpu_torch.evaluation.decode import (
    center_to_corners, corners_to_image, decode_heads,
)
from modelcompression_tpu_torch.evaluation.nms import (
    batched_per_class_nms, batched_per_class_nms_padded,
    batched_per_class_nms_prefiltered, batched_per_class_soft_nms,
)
from modelcompression_tpu_torch.evaluation.voc_map import (
    Detection, GroundTruth, coco_map, coco_map_by_area, mean_ap,
)
from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import (
    Params, fold_batchnorm, forward, forward_folded, params_to,
)
from modelcompression_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class EvalConfig:
    """Evaluation and serving-step configuration; field names follow the
    JAX package.

    ``fuse_input_stage`` defaults to True here, where the JAX package
    defaults it to False. The JAX default is a TPU-toolchain finding (the
    Mosaic lane padding of a 12-channel minor dim made the Pallas kernel
    slower than XLA's conv+pool); it says nothing about the H100, where
    conv1 at 416x416 with 3 input channels wastes the tensor cores and
    writes a large full-resolution intermediate. The fusion still only
    applies when ``fold_bn`` and ``input_stage_match(spec)`` hold.

    Values the JAX package rejects raise what it raises, in its order
    (``ValueError``). ``forward_fn(params, x, spec)`` replaces the
    network forward (the int8 path, ``compress.forward_quantized``, with
    its quantized pytree as the params, which ``evaluate`` then never
    BN-folds); ``int8_input`` quantizes the canvas on the pytree's
    ``__net__/input_scale`` grid before it. The NMS variants (``exact_nms``,
    ``soft_nms`` with ``soft_nms_sigma``, ``diou_nms`` with
    ``diou_beta``, ``nms_prefilter_impl='bisect'``,
    ``exact_nms_prefilter=False``) are those of ``nms.py``.
    """

    batch_size: int = 8
    conf_thresh: float = 0.005
    nms_thresh: float = 0.45
    max_detections: int = 100
    use_07_metric: bool = True
    # VOC devkit +1 inclusive-pixel IoU for AP matching (boxes are in
    # source pixels, so the devkit convention is the parity-correct one)
    devkit_iou: bool = True
    # AP matching IoU threshold (0.5: the VOC headline mAP@50)
    map_iou: float = 0.5
    # also compute mAP@[.50:.95] (voc_map.coco_map) from the same lists
    coco_map: bool = False
    letterbox: bool = True
    precision: Precision = FAST
    fold_bn: bool = True
    # False: the JAX package's approx_max_k candidate prefilter; no
    # counterpart on this device, so the exact sort (the same result as True)
    exact_nms_prefilter: bool = True
    # exact greedy NMS over ALL candidates (nms.nms_padded): max_detections
    # serial argmax rounds per (image, class); the mAP-audit switch
    exact_nms: bool = False
    # class-agnostic top-N' candidate prefilter before the per-class NMS
    # sorts; 0 = off. Exact while at most N' candidates of an image have
    # any class above conf_thresh (the step's n_any counter shows it).
    nms_prefilter: int = 0
    # 'topk' (per-image stable sort) or 'bisect' (the sort-free segmented
    # select through the top-k kernels, nms.batched_bisect_prefilter)
    nms_prefilter_impl: str = "topk"
    # Soft-NMS: "" off, "gaussian" (s *= exp(-iou^2/soft_nms_sigma)) or
    # "linear" (s *= 1-iou above nms_thresh)
    soft_nms: str = ""
    soft_nms_sigma: float = 0.5
    # DIoU-NMS: suppress on IoU - (rho^2/c^2)^diou_beta > nms_thresh
    diou_nms: bool = False
    diou_beta: float = 1.0
    fuse_input_stage: bool = True
    forward_fn: Optional[object] = None
    int8_input: bool = False
    # the device the step runs on; "cuda" unless the caller asks for "cpu"
    device: str = "cuda"

    def __post_init__(self):
        # the JAX package's checks (modelcompression_tpu/evaluation/
        # pipeline.py EvalConfig.__post_init__), in its order
        if not 0.0 < self.map_iou <= 1.0:
            raise ValueError(f"map_iou must be in (0, 1], got {self.map_iou}")
        if self.exact_nms and self.nms_prefilter > 0:
            raise ValueError(
                "exact_nms and nms_prefilter are mutually exclusive: the "
                "exact path runs greedy NMS over ALL candidates, so a "
                "candidate prefilter would silently not apply; drop one "
                "of the two flags")
        if self.nms_prefilter_impl not in ("topk", "bisect"):
            raise ValueError(
                f"nms_prefilter_impl must be 'topk' or 'bisect', got "
                f"{self.nms_prefilter_impl!r}")
        if self.soft_nms not in ("", "linear", "gaussian"):
            raise ValueError(
                f"soft_nms must be '', 'linear' or 'gaussian', got "
                f"{self.soft_nms!r}")
        if self.soft_nms and (self.exact_nms or self.nms_prefilter > 0):
            raise ValueError(
                "soft_nms is mutually exclusive with exact_nms / "
                "nms_prefilter: those select variants of GREEDY erasure "
                "NMS, soft-NMS replaces the erasure rule itself")
        if self.soft_nms and self.diou_nms:
            raise ValueError(
                "soft_nms and diou_nms are mutually exclusive: diou_nms "
                "changes the greedy erasure criterion, soft_nms replaces "
                "erasure with score decay")
        if self.int8_input and self.forward_fn is None:
            raise ValueError(
                "int8_input requires a forward_fn that accepts an int8 "
                "canvas (compress.forward_quantized): the standard float "
                "forward has no input grid to land on")


def _network(spec: NetworkSpec, config: EvalConfig,
             src_hw: Optional[Tuple[int, int]]):
    """The part every step shares: fn(params, images) -> raw map on the
    params' device, with the device check, the input (letterbox on the
    device or normalize; quantized on the pytree's input grid under
    ``int8_input``) and the forward (``config.forward_fn`` when set, else
    the fused input stage where ``config.fuse_input_stage``, ``fold_bn``
    and ``input_stage_match`` hold). Raises at build time when the device
    is CUDA and CUDA is absent."""
    spec.head_indices()  # validate: every spec has [region] or [yolo] heads
    device = resolve_device(config.device)
    # BITMATCH steps run with TF32 off for cuDNN convs and cuBLAS matmuls
    config.precision.apply_backend_flags()
    net_h, net_w = spec.net.height, spec.net.width
    fuse = config.fuse_input_stage
    if fuse:
        from modelcompression_tpu_torch.ops.input_stage import (
            input_stage_match,
        )
        fuse = config.fold_bn and input_stage_match(spec)
    # FAST resizes in bf16 (the conv stack rounds its input to bf16 anyway);
    # BITMATCH keeps the resize in fp32
    rs_dtype = (config.precision.compute_dtype
                if config.precision.name == "fast" else torch.float32)

    def raw_map(params: Params, images):
        p_dev = next(iter(next(iter(params.values())).values())).device
        if p_dev.type != device.type or (device.index is not None
                                         and p_dev != device):
            raise ValueError(f"params live on {p_dev}, the step runs on "
                             f"{device}")
        with span("serve.letterbox"):
            images = torch.as_tensor(images, device=p_dev)
            # the int8 canvas lands on the pytree's own input grid, so a
            # recalibration changes producer and consumer together
            qs = params["__net__"]["input_scale"] if config.int8_input \
                else None
            if src_hw is not None:
                if tuple(images.shape[1:3]) != tuple(src_hw):
                    raise ValueError(f"step built for {src_hw} sources, "
                                     f"got {tuple(images.shape[1:3])}")
                resize = (letterbox_device if config.letterbox
                          else stretch_resize_device)
                x = resize(images, net_h, net_w, dtype=rs_dtype,
                           quant_scale=qs)
            else:
                x = images.to(rs_dtype) / 255.0
                if qs is not None:
                    x = quantize_canvas(x, qs)
        with span("serve.forward"):
            if config.forward_fn is not None:
                return config.forward_fn(params, x, spec)
            if config.fold_bn:
                return forward_folded(params, x, spec, config.precision,
                                      fuse_input_stage=fuse)
            return forward(params, x, spec, config.precision)

    return raw_map


def make_eval_step(spec: NetworkSpec, config: EvalConfig,
                   src_hw: Optional[Tuple[int, int]] = None):
    """Build the serving step.

    Returns fn(params, images_uint8, img_w (B,), img_h (B,)) ->
      (boxes (B,C,K,4) in source-image pixels, scores (B,C,K),
       valid (B,C,K), n_cand (B,C) int32, n_any (B,) int32):
      * n_cand — candidates above conf_thresh per (image, class);
      * n_any — candidates whose max class score clears conf_thresh per
        image (the class-agnostic prefilter's exactness budget).

    ``images_uint8`` is (B, net, net, 3) when ``src_hw is None``, else
    (B, src_h, src_w, 3) source frames. Inputs may be numpy arrays or
    tensors; they are moved to ``config.device``. Params must already live
    there (raises otherwise): the step follows the device of its params.
    Raises at build time when the device is CUDA and CUDA is absent.
    """
    raw_map = _network(spec, config, src_hw)
    net_h, net_w = spec.net.height, spec.net.width

    def postprocess(raw, img_w, img_h):
        """Decode, NMS and the map back to source-image pixels."""
        boxes, obj, cls = decode_heads(raw, spec)
        dev = boxes.device
        img_w = torch.as_tensor(img_w, dtype=torch.float32, device=dev)
        img_h = torch.as_tensor(img_h, dtype=torch.float32, device=dev)
        class_scores = obj[..., None] * cls                # (B, N, C)
        corners = center_to_corners(boxes)
        n_cand = (class_scores > config.conf_thresh).sum(
            dim=1, dtype=torch.int32)                      # (B, C)
        n_any = (class_scores.amax(dim=-1) > config.conf_thresh).sum(
            dim=-1, dtype=torch.int32)                     # (B,)
        common = dict(iou_thresh=config.nms_thresh,
                      score_thresh=config.conf_thresh,
                      max_out=config.max_detections)
        diou = dict(diou=config.diou_nms, diou_beta=config.diou_beta)
        if config.soft_nms:
            sel, scores, valid = batched_per_class_soft_nms(
                corners, class_scores, **common,
                sigma=config.soft_nms_sigma,
                linear=(config.soft_nms == "linear"))
        elif config.exact_nms:
            sel, scores, valid = batched_per_class_nms_padded(
                corners, class_scores, **common, **diou)
        elif config.nms_prefilter > 0:
            sel, scores, valid = batched_per_class_nms_prefiltered(
                corners, class_scores, **common,
                prefilter=config.nms_prefilter,
                exact_prefilter=config.exact_nms_prefilter, **diou,
                impl=config.nms_prefilter_impl)
        else:
            sel, scores, valid = batched_per_class_nms(
                corners, class_scores, **common,
                exact_prefilter=config.exact_nms_prefilter, **diou)
        sel = corners_to_image(sel, img_w[:, None, None],
                               img_h[:, None, None], net_w, net_h,
                               config.letterbox)
        return sel, scores, valid, n_cand, n_any

    def step(params: Params, images, img_w, img_h):
        with span("serve.step"), torch.inference_mode():
            raw = raw_map(params, images)
            with span("serve.postprocess"):
                return postprocess(raw, img_w, img_h)

    return step


def _prep_batch(samples: Sequence[Sample], net_h: int, net_w: int,
                letterbox: bool, executor=None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side: decode + letterbox to a fixed uint8 canvas.

    ``executor``: optional ThreadPoolExecutor; zlib (PNG), cv2 and the
    large numpy copies release the GIL, so per-image prep parallelizes
    across host cores.

    Returns (batch (B,net,net,3) uint8, img_w (B,), img_h (B,))."""
    batch = np.zeros((len(samples), net_h, net_w, 3), np.uint8)
    img_w = np.ones(len(samples), np.float32)
    img_h = np.ones(len(samples), np.float32)

    def prep_one(i_s):
        i, s = i_s
        img = s.load_image()
        h, w = img.shape[:2]
        if letterbox:
            batch[i] = letterbox_host(img, net_h, net_w)[0]
        else:
            batch[i] = resize_host(img, net_w, net_h)
        img_w[i], img_h[i] = w, h

    if executor is not None:
        # list() propagates the first worker exception
        list(executor.map(prep_one, enumerate(samples)))
    else:
        for item in enumerate(samples):
            prep_one(item)
    return batch, img_w, img_h


def _pad_batch(batch: np.ndarray, img_w: np.ndarray, img_h: np.ndarray,
               size: int):
    """Pad a ragged last batch to ``size`` rows: zero canvases with an
    image size of 1x1. Callers drop the padding rows from every count
    (``[:len(chunk)]``)."""
    pad_to = size - len(batch)
    if pad_to:
        batch = np.concatenate([batch, np.zeros((pad_to, *batch.shape[1:]),
                                                np.uint8)])
        img_w = np.concatenate([img_w, np.ones(pad_to, np.float32)])
        img_h = np.concatenate([img_h, np.ones(pad_to, np.float32)])
    return batch, img_w, img_h


def evaluate(params: Params, spec: NetworkSpec, samples: Sequence[Sample],
             class_names: Sequence[str], config: EvalConfig | None = None,
             mesh=None) -> "EvalResult":
    """Full dataset eval -> mAP + per-class AP + throughput.

    ``params`` (unfolded, on any device) are BN-folded when
    ``config.fold_bn`` and no ``forward_fn`` is set (a custom forward owns
    its params' layout: the int8 pytree is folded and quantized already),
    and moved to ``config.device``. All boxes (GT and detections) are
    kept in source-image pixel coordinates.

    ``mesh``: a mesh with a 'data' axis (``core.mesh.make_mesh`` on
    ``config.device``): the params are replicated to each of its devices,
    each batch is split over them, the step runs once per shard on its
    device's current stream, and the outputs are concatenated in batch
    order (``parallel.data_parallel``); the results equal the
    single-device run's. The batch size must divide the data axis."""
    config = config or EvalConfig()
    device = resolve_device(config.device)
    if config.fold_bn and config.forward_fn is None:
        params = fold_batchnorm(params, spec)
    step = make_eval_step(spec, config)
    net_h, net_w = spec.net.height, spec.net.width
    bs = config.batch_size
    if mesh is not None:
        from modelcompression_tpu_torch.parallel import (
            data_parallel, replicate, shard_batch,
        )
        dp = mesh.shape.get("data", 1)
        if bs % dp:
            raise ValueError(
                f"eval batch {bs} not divisible by data-parallel size {dp}")
        params = replicate(params, mesh)
        run = data_parallel(step, mesh).run_shards

        def to_dev(arrs):
            return shard_batch(arrs, mesh)
    else:
        params = params_to(params, device)

        def run(p, dev_arrs):
            return step(p, *dev_arrs)

        def to_dev(arrs):
            return to_device(arrs, device)

    dets: Dict[str, List[Detection]] = {c: [] for c in class_names}
    gts: Dict[str, List[GroundTruth]] = {c: [] for c in class_names}

    # per-image host prep fans out over host cores inside the prefetch
    # thread; a 1-core host runs it serially
    n_workers = max(1, min(16, os.cpu_count() or 1))
    prep_pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=n_workers) if n_workers > 1 else None

    def host_batches():
        """Producer: decode + letterbox + collate on the host (runs in the
        prefetch thread, overlapped with device compute)."""
        for start in range(0, len(samples), bs):
            chunk = list(samples[start:start + bs])
            arrs = _pad_batch(*_prep_batch(chunk, net_h, net_w,
                                           config.letterbox,
                                           executor=prep_pool), bs)
            yield chunk, arrs

    def put(item):
        chunk, arrs = item
        return chunk, arrs[1:], to_dev(arrs)

    n_images = 0
    t_loop0 = time.perf_counter()
    first_dev = []  # first batch's device inputs (single-batch steady timing)

    def fetch(outs):
        return tuple(t.cpu().numpy() for t in outs)

    def batch_results():
        """Dispatch batch i, then fetch batch i-1's small outputs (the
        input side is prefetch_to_device)."""
        pending = None
        for chunk, (img_w, img_h), dev_arrs in prefetch_to_device(
                host_batches(), depth=2, device=device, put=put):
            if not first_dev:
                first_dev.append(dev_arrs)
            outs = run(params, dev_arrs)
            if pending is not None:
                p_chunk, p_w, p_h, p_outs = pending
                yield p_chunk, p_w, p_h, fetch(p_outs)
            pending = (chunk, img_w, img_h, outs)
        if pending is not None:
            p_chunk, p_w, p_h, p_outs = pending
            yield p_chunk, p_w, p_h, fetch(p_outs)

    n_cells = 0
    n_overflow = 0
    max_cand = 0
    n_pf_overflow = 0
    max_any = 0
    n_batches = 0
    t_first = None
    n_first = 0
    try:
        for chunk, img_w, img_h, (boxes, scores, valid, n_cand, n_any) \
                in batch_results():
            n_batches += 1
            if t_first is None:
                # the first results end the one-off costs (kernel build and
                # load, cuDNN set-up, first host prep and copy); everything
                # after is the steady-state pipeline
                t_first = time.perf_counter()
                n_first = len(chunk)
            n_images += len(chunk)
            real = n_cand[:len(chunk)]  # exclude batch padding rows
            n_cells += real.size
            n_overflow += int((real > config.max_detections).sum())
            max_cand = max(max_cand, int(real.max()) if real.size else 0)
            real_any = n_any[:len(chunk)]
            max_any = max(max_any,
                          int(real_any.max()) if real_any.size else 0)
            if config.nms_prefilter > 0:
                n_pf_overflow += int((real_any > config.nms_prefilter).sum())

            for bi, s in enumerate(chunk):
                w, h = float(img_w[bi]), float(img_h[bi])
                # ground truth in source pixels (labels are normalized
                # cx cy w h)
                diff = (s.difficult if s.difficult is not None
                        else np.zeros(len(s.labels), bool))
                for row, d in zip(s.labels, diff):
                    cls, cx, cy, bw, bh = row
                    gts[class_names[int(cls)]].append(GroundTruth(
                        image_id=s.image_id,
                        box=((cx - bw / 2) * w, (cy - bh / 2) * h,
                             (cx + bw / 2) * w, (cy + bh / 2) * h),
                        difficult=bool(d)))
                for ci, cname in enumerate(class_names):
                    v = valid[bi, ci]
                    if not v.any():
                        continue
                    for k in np.nonzero(v)[0]:
                        dets[cname].append(Detection(
                            image_id=s.image_id,
                            score=float(scores[bi, ci, k]),
                            box=tuple(float(x) for x in boxes[bi, ci, k])))
    finally:
        if prep_pool is not None:
            prep_pool.shutdown(wait=True)

    # wall time over the whole pipelined loop (prefetch puts + device
    # compute + output fetch + host accumulation), not device-only time
    t_end = time.perf_counter()
    wall_time = t_end - t_loop0
    # steady-state pipeline throughput: leave out the first batch. A
    # single-batch run times one more run of the step instead.
    first_batch_s = (t_first - t_loop0) if t_first is not None else 0.0
    if n_batches > 1 and t_first is not None:
        ips_steady = (n_images - n_first) / max(t_end - t_first, 1e-9)
    elif n_batches == 1 and first_dev:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        [t.cpu() for t in run(params, first_dev[0])]
        ips_steady = n_first / max(time.perf_counter() - t0, 1e-9)
    else:
        ips_steady = 0.0
    m, per_class = mean_ap(dets, gts, iou_thresh=config.map_iou,
                           use_07_metric=config.use_07_metric,
                           devkit_iou=config.devkit_iou)
    m_coco, per_class_coco, coco_area = (None, None, None)
    if config.coco_map:
        m_coco, per_class_coco = coco_map(dets, gts,
                                          devkit_iou=config.devkit_iou)
        coco_area = coco_map_by_area(dets, gts,
                                     devkit_iou=config.devkit_iou)
    return EvalResult(
        map50=m, per_class_ap=per_class, detections=dets,
        n_images=n_images,
        images_per_sec=n_images / wall_time if wall_time else 0.0,
        images_per_sec_steady=ips_steady,
        first_batch_s=first_batch_s,
        use_07_metric=config.use_07_metric,
        map_iou=config.map_iou,
        nms_overflow_frac=(n_overflow / n_cells if n_cells else 0.0),
        nms_max_candidates=max_cand,
        max_detections=config.max_detections,
        exact_nms=config.exact_nms,
        nms_prefilter=config.nms_prefilter,
        prefilter_overflow_frac=(n_pf_overflow / n_images
                                 if n_images else 0.0),
        prefilter_max_candidates=max_any,
        map_coco=m_coco, per_class_ap_coco=per_class_coco,
        map_coco_area=coco_area, device=str(device))


@dataclasses.dataclass
class EvalResult:
    # mean AP at map_iou (the name keeps the headline metric's spelling)
    map50: float
    per_class_ap: Dict[str, float]
    detections: Dict[str, List[Detection]]
    n_images: int
    # end-to-end pipeline wall throughput (host prep + copies + device
    # compute + fetch), first batch included
    images_per_sec: float
    use_07_metric: bool
    # steady-state pipeline throughput: first batch left out (a
    # single-batch run times one more run of the step instead)
    images_per_sec_steady: float = 0.0
    # wall time until the first batch's results: host prep, copy, the
    # kernels' first build or load, cuDNN set-up, compute and fetch
    first_batch_s: float = 0.0
    map_iou: float = 0.5
    # NMS truncation: fraction of (image, class) cells whose candidate
    # count exceeded max_detections (where top-k NMS can differ from
    # exact greedy), and the worst cell's count
    nms_overflow_frac: float = 0.0
    nms_max_candidates: int = 0
    max_detections: int = 0
    # the run used exact greedy NMS over all candidates (nms_padded)
    exact_nms: bool = False
    # class-agnostic prefilter: fraction of images whose any-class
    # candidate count exceeded nms_prefilter, and the worst image's count
    nms_prefilter: int = 0
    prefilter_overflow_frac: float = 0.0
    prefilter_max_candidates: int = 0
    # mAP@[.50:.95] (voc_map.coco_map; None unless EvalConfig.coco_map)
    map_coco: Optional[float] = None
    per_class_ap_coco: Optional[Dict[str, float]] = None
    # COCO size bands {small, medium, large} -> AP@[.50:.95] (None for a
    # band without ground truth), beside map_coco
    map_coco_area: Optional[Dict[str, float]] = None
    # the device the step ran on
    device: str = ""

    def summary(self) -> str:
        at = f"{self.map_iou * 100:g}"
        coco = self.per_class_ap_coco
        lines = [f"{'class':<16} AP@{at}"
                 + ("  AP@[.50:.95]" if coco is not None else "")]
        for c, ap in sorted(self.per_class_ap.items()):
            row = f"{c:<16} {ap * 100:6.2f}"
            if coco is not None:
                row += f"  {coco.get(c, 0.0) * 100:6.2f}"
            lines.append(row)
        proto = "11-point" if self.use_07_metric else "all-point"
        lines.append(f"mAP@{at} ({proto}): {self.map50 * 100:.2f}  "
                     f"[{self.n_images} images, "
                     f"{self.images_per_sec:.1f} img/s pipeline wall]")
        if self.images_per_sec_steady > 0.0:
            lines.append(
                f"throughput: {self.images_per_sec_steady:.1f} img/s "
                f"steady-state pipeline on {self.device} (first batch "
                f"excluded: {self.first_batch_s:.1f}s incl. kernel load "
                "and warm-up)")
        if self.map_coco is not None:
            lines.append(f"mAP@[.50:.95] (all-point, COCO IoU ladder): "
                         f"{self.map_coco * 100:.2f}")
        if self.map_coco_area is not None:
            lines.append("AP by object size: " + "  ".join(
                f"{band}={'n/a' if ap is None else f'{ap * 100:.2f}'}"
                for band, ap in self.map_coco_area.items()))
        if self.exact_nms:
            lines.append(
                f"NMS: exact greedy over all candidates "
                f"(worst cell {self.nms_max_candidates} candidates; "
                f"output capped at {self.max_detections} survivors)")
            return "\n".join(lines)
        exact_run = self.nms_overflow_frac == 0.0
        lines.append(
            f"NMS: top-{self.max_detections} prefilter; "
            f"{self.nms_overflow_frac:.2%} of (image,class) cells "
            f"exceeded it (worst {self.nms_max_candidates})")
        if self.nms_prefilter > 0:
            # the class-agnostic prefilter has its own (per-image)
            # exactness budget: both must hold for the exact claim
            exact_run = exact_run and self.prefilter_overflow_frac == 0.0
            lines.append(
                f"NMS: class-agnostic prefilter {self.nms_prefilter}; "
                f"{self.prefilter_overflow_frac:.2%} of images "
                f"exceeded it (worst {self.prefilter_max_candidates} "
                f"any-class candidates)")
        lines.append(
            "NMS: exact-equal to greedy NMS on this run" if exact_run
            else "NMS: re-run with exact_nms (eval --exact-nms) to audit")
        return "\n".join(lines)


def dump_detections(result: EvalResult, out_dir: str,
                    prefix: str = "comp4_det_test") -> None:
    """Write VOC-devkit-format per-class detection files: one file per
    class, rows ``image_id score x1 y1 x2 y2`` in source-image pixels (the
    units ``evaluate`` stores)."""
    os.makedirs(out_dir, exist_ok=True)
    for cname, dets in result.detections.items():
        path = os.path.join(out_dir, f"{prefix}_{cname}.txt")
        with open(path, "w") as f:
            for d in sorted(dets, key=lambda d: -d.score):
                x1, y1, x2, y2 = d.box
                f.write(f"{d.image_id} {d.score:.6f} "
                        f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}\n")
