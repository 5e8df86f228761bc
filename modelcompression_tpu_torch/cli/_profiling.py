"""Timing and profiler windows on the card, shared by the ``profile_*``
command lines."""

from __future__ import annotations

import time

import torch

from modelcompression_tpu_torch.utils.timing import time_fn


def time_ms(fn, iters=10, warmup=2):
    """Mean ms per call of ``fn`` over one window of ``iters`` calls, CUDA
    events, after warm-up and a synchronize (``utils.timing.time_fn``)."""
    return time_fn(fn, iters=iters, windows=1, warmup=warmup) * 1e3


def profile_window(fn, steps=3):
    """A ``torch.profiler`` window over ``steps`` calls of ``fn`` (after
    one warm-up call). Returns the summary (device busy and idle share of
    the wall time, device operations per step, top 12 kernels) and the
    device rows ``(name, device us, calls)``, most time first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the CPU-op rows carry
    # the same device time again
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    summary = {
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "device_ops_per_step": sum(r[2] for r in rows) / steps,
        "top_kernels": [{"name": k[:90], "ms_per_step": us / steps / 1e3,
                         "calls_per_step": n / steps}
                        for k, us, n in rows[:12]],
    }
    return summary, rows
