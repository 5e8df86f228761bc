"""Closed-loop batch serving through the port's serving step.

Set-up, all from the seed: the frame pool, the raw weights, the cell's
compression recipe through the port's own keep-sets and repack, the
serving pytree (``cli.common.prepare_serving``: BN folded, on the card)
and the step (``evaluation.make_eval_step`` with the device letterbox),
then ``warmup_batches`` batches through the loop below.

The loop is ``evaluation.evaluate``'s: a producer thread makes each batch
on the host, a fresh seeded draw of ``batch`` distinct frames of the
pool gathered into one array (a ring of arrays allocated once), and
hands it to the port's ``data/streaming.prefetch_to_device``
(``to_device``: pinned again, then copied to the card without blocking
the host), ``depth`` batches ahead; the
main thread hands each batch to the step and dispatches it before the
previous batch is fetched to host memory. A batch counts when its
detections reached host memory inside the window.

After the window a seeded sample of the counted batches is served again
by the reference and compared (``reference.detect.compare``).
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

from h100_bench import inputs, trace as tracing
from h100_bench.reference import arith, cfg as refcfg, detect, model, prune


class _Loop:
    """Dispatch batch i, then fetch batch i-1, over the producer's fresh
    draws."""

    def __init__(self, step, params, pool, traffic, seed, device):
        from modelcompression_tpu_torch.cli.common import fetch_batch
        from modelcompression_tpu_torch.data.streaming import (
            prefetch_to_device, to_device,
        )
        self.step, self.params = step, params
        self.fetch_batch = fetch_batch
        batch = traffic["batch"]
        draws = inputs.batch_draws(seed, len(pool), batch)
        dev = torch.device(device)

        # each producer stage's (end, seconds), read against the window
        self.stages = {"gather": [], "put": [], "wait": []}

        def timed(stage, fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            end = time.perf_counter()
            self.stages[stage].append((end, end - t))
            return out

        # the gather writes into a ring of buffers allocated once, more
        # than the feed holds at a time (the queue, the batch in the
        # step, the one being made), so no batch pays fresh pages
        ring = [np.zeros((batch,) + pool.shape[1:], pool.dtype)
                for _ in range(traffic["depth"] + 3)]

        def host_batches():
            for i, idx in enumerate(draws):
                yield idx, timed("gather", np.take, pool, idx, 0,
                                 ring[i % len(ring)], "clip")

        def put(item):
            return item[0], timed("put", to_device, item[1], dev)

        self.feed = prefetch_to_device(host_batches(),
                                       depth=traffic["depth"], device=dev,
                                       put=put)
        self.img_w = np.full(batch, traffic["src_w"], np.float32)
        self.img_h = np.full(batch, traffic["src_h"], np.float32)
        self.pending = None
        self.enqueue_s = []

    def dispatch(self, spans: bool):
        ctx = tracing.span if spans else (lambda _: contextlib.nullcontext())
        with ctx("feed"):
            idx, frames = self._next()
        with ctx("step"):
            t = time.perf_counter()
            outs = self.step(self.params, frames, self.img_w, self.img_h)
            self.enqueue_s.append(time.perf_counter() - t)
        prev, self.pending = self.pending, (idx, outs[:3])
        if prev is None:
            return None
        with ctx("fetch"):
            return prev[0], self.fetch_batch(prev[1])

    def _next(self):
        """The producer's next batch, timing the main thread's wait."""
        t = time.perf_counter()
        got = next(self.feed)
        end = time.perf_counter()
        self.stages["wait"].append((end, end - t))
        return got

    def stage_ms(self, lo: float, hi: float) -> dict:
        """Mean milliseconds of each feed stage that ended in [lo, hi]."""
        out = {}
        for name, spans in self.stages.items():
            d = [s for end, s in list(spans) if lo <= end <= hi]
            if d:
                out[f"feed_{name}_ms"] = round(1e3 * sum(d) / len(d), 3)
        return out

    def drain(self):
        prev, self.pending = self.pending, None
        return None if prev is None else (prev[0],
                                          self.fetch_batch(prev[1]))

    def close(self):
        """End the producer thread and wait for it."""
        self.feed.close()


def run(cell, config, traffic, seed, seconds, trace, t0, device):
    from modelcompression_tpu_torch.cli.common import prepare_serving
    from modelcompression_tpu_torch.compress.criteria import (
        l1_filter_keep_sets,
    )
    from modelcompression_tpu_torch.compress.repack import repack
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models.cfg import load_cfg

    path = inputs.cfg_path(config)
    net, layers = refcfg.read(path)
    batch, src_hw = traffic["batch"], (traffic["src_h"], traffic["src_w"])
    pool = inputs.frame_pool(traffic["pool"], *src_hw, seed, device)
    raw = inputs.raw_params(net, layers, seed, device, pool)
    raw_host = {k: {n: v.cpu() for n, v in p.items()}
                for k, p in raw.items()}
    if device == "cuda":
        # the peak from here on is the program's: its inputs, set-up,
        # warm-up and window
        torch.cuda.reset_peak_memory_stats()
    serving = cell["serving"]
    recipe = cell.get("recipe")

    spec = load_cfg(path)
    params = raw
    if recipe:
        keep = l1_filter_keep_sets(raw, spec, recipe["fraction"])
        spec, params = repack(spec, raw, keep)
    ecfg = EvalConfig(conf_thresh=serving["conf"],
                      nms_thresh=serving["nms"],
                      max_detections=serving["max_detections"],
                      nms_prefilter=serving["nms_prefilter"],
                      precision=FAST, device=device)
    params, ecfg = prepare_serving(spec, params, False, ecfg)
    del raw
    step = make_eval_step(spec, ecfg, src_hw=src_hw)
    loop = _Loop(step, params, pool, traffic, seed + 2, device)
    try:
        for _ in range(traffic["warmup_batches"]):
            loop.dispatch(spans=False)
        loop.drain()
        sync(device)
        setup_s = time.monotonic() - t0
        loop.enqueue_s.clear()

        sample, k, n_counted = [], traffic["check_batches"], 0
        picker = random.Random(seed + 3)
        dispatched = 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            got = loop.dispatch(spans=False)
            dispatched += 1
            if got is None or time.perf_counter() > t_end:
                continue
            n_counted += 1
            if len(sample) < k:
                sample.append(got)
            else:
                j = picker.randrange(n_counted)
                if j < k:
                    sample[j] = got
        loop.drain()
        sync(device)
        enqueue_s = list(loop.enqueue_s)
        stage_ms = loop.stage_ms(t_start, t_end)

        summary = None
        if trace:
            def traced_steps():
                for _ in range(traffic["trace_batches"]):
                    loop.dispatch(spans=True)
                with tracing.span("sync"):
                    loop.drain()
                    sync(device)
            summary = tracing.traced(traced_steps)
    finally:
        # the producer thread ends and is waited for
        loop.close()
    peak = (torch.cuda.max_memory_allocated()
            if device == "cuda" else 0)
    del step, params, loop
    if device == "cuda":
        torch.cuda.empty_cache()

    check, slim = reference_check(net, layers, raw_host, recipe, serving,
                                  cell["match_band"], pool, sample, device)
    first_conv = next(l for l in slim if l["type"] == "conv")
    rate = n_counted * batch / seconds
    return {
        "metrics": {"serve_img_per_s": rate, "setup_s": setup_s},
        "attempted": dispatched * batch, "failed": 0,
        "memory_peak_bytes": int(peak), "trace": summary,
        "check": check, "limits": cell["check"],
        "driver": "stream", "rate": rate,
        "flops_per_img": arith.conv_flops(slim),
        "spans": {"step_enqueue_s": enqueue_s},
        "shapes": {"batch": batch, "net_h": int(net["height"]),
                   "net_w": int(net["width"]),
                   "conv1_filters": first_conv["filters"]},
        "notes": {"batches_counted": n_counted,
                  "batches_compared": len(sample),
                  "det_gap_served": check.get("served"),
                  "det_gap_overlap": check.get("overlap"),
                  "det_gap_held": check.get("held"), **stage_ms},
    }


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def reference_check(net, layers, raw_host, recipe, serving, band, pool,
                    sample, device):
    """The reference's numbers over the sampled batches (the worst of
    each; none without a sample), and its own slimmed layers."""
    model.strict_fp32()
    raw = {k: {n: v.to(device) for n, v in p.items()}
           for k, p in raw_host.items()}
    ref_layers, params = prune.apply_recipe(raw, net, layers, recipe)
    folded = model.fold(params, ref_layers)
    worst = {}
    for idx, outs in sample:
        frames = torch.as_tensor(pool[idx], device=device)
        ref = detect.serve(folded, net, ref_layers, frames, serving)
        for name, v in detect.compare(outs, ref, serving, band).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst, ref_layers


def control(cell, config, traffic, seed, device):
    """The control: the reference in float8 put in the program's place,
    on the first ``check_batches`` draws of the cell's traffic, judged by
    the same numbers. Returns the worst of each."""
    path = inputs.cfg_path(config)
    net, layers = refcfg.read(path)
    batch, src_hw = traffic["batch"], (traffic["src_h"], traffic["src_w"])
    pool = inputs.frame_pool(traffic["pool"], *src_hw, seed, device)
    raw = inputs.raw_params(net, layers, seed, device, pool)
    model.strict_fp32()
    ref_layers, params = prune.apply_recipe(raw, net, layers,
                                            cell.get("recipe"))
    folded = model.fold(params, ref_layers)
    serving = cell["serving"]
    draws = inputs.batch_draws(seed + 2, traffic["pool"], batch)
    worst = {}
    for _ in range(traffic["check_batches"]):
        frames = torch.as_tensor(pool[next(draws)], device=device)
        ref = detect.serve(folded, net, ref_layers, frames, serving)
        low = detect.serve(folded, net, ref_layers, frames, serving,
                           lowp="fp8")
        for name, v in detect.compare(low["det"], ref, serving,
                                      cell["match_band"]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst
