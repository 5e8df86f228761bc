"""Profiler windows on the card, shared by the ``profile_*`` command
lines."""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from modelcompression_tpu_torch.utils.profiling import SPAN_PREFIX

WINDOW = "profile_window"


def merge_intervals(intervals: Iterable[Tuple[float, float]]
                    ) -> List[List[float]]:
    """The union of ``(start, end)`` intervals as sorted, disjoint
    ``[start, end]`` runs (empty intervals dropped)."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_and_idle(busy: Iterable[Tuple[float, float]],
                  spans: Iterable[Tuple[str, float, float]],
                  lo: float, hi: float
                  ) -> Tuple[float, Dict[Optional[str], float]]:
    """Over the window ``[lo, hi]``: the length the ``busy`` intervals
    cover (their union, not their sum), and the rest, the idle time, by
    the innermost ``(name, start, end)`` span covering it (the one that
    started last; None where no span covers it)."""
    spans = [(s, -e, name) for name, s, e in spans]
    merged = merge_intervals((max(s, lo), min(e, hi)) for s, e in busy)
    cuts = sorted({v for s, ne, _ in spans for v in (s, -ne)
                   if lo < v < hi})
    edges = [lo] + [v for run in merged for v in run] + [hi]
    idle: Dict[Optional[str], float] = collections.defaultdict(float)
    for gs, ge in zip(edges[0::2], edges[1::2]):
        points = [gs] + [c for c in cuts if gs < c < ge] + [ge]
        for a, b in zip(points, points[1:]):
            mid = (a + b) / 2
            covering = [sp for sp in spans if sp[0] <= mid < -sp[1]]
            idle[max(covering)[2] if covering else None] += b - a
    return sum(e - s for s, e in merged), dict(idle)


def profile_window(fn, steps=3):
    """A ``torch.profiler`` window over ``steps`` calls of ``fn`` (after
    one warm-up call). Returns the summary and the device rows ``(name,
    device us, calls)``, most time first.

    The summary: the window's ms a step; the device's busy ms a step (the
    union of its kernels' and copies' intervals) and idle share of the
    window; device operations and the top 12 kernels a step; and for each
    of the program's spans (``utils.profiling.span``) run in the window,
    its host ms a step and the device idle ms a step under it (idle time
    counted to the innermost span open on the host;
    ``idle_ms_per_step_outside_spans`` the rest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
    window, spans, device = None, [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the host ranges' device-side annotations are not device work
            if end > start and not getattr(e, "is_user_annotation", False):
                device.append((e.name, start, end))
        elif e.name == WINDOW:
            window = (start, end)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], start, end))
    lo, hi = window
    busy_us, idle_us = busy_and_idle(((s, e) for _, s, e in device),
                                     spans, lo, hi)
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    for name, s, e in device:
        by_name[name][0] += e - s
        by_name[name][1] += 1
    rows = sorted(((k, us, n) for k, (us, n) in by_name.items()),
                  key=lambda r: -r[1])
    host_us: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in spans:
        host_us[name] += e - s
    wall_us = hi - lo
    summary = {
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "device_ops_per_step": sum(r[2] for r in rows) / steps,
        "top_kernels": [{"name": k[:90], "ms_per_step": us / steps / 1e3,
                         "calls_per_step": n / steps}
                        for k, us, n in rows[:12]],
        "spans": {name: {"host_ms_per_step": us / steps / 1e3,
                         "idle_ms_per_step":
                             idle_us.get(name, 0.0) / steps / 1e3}
                  for name, us in sorted(host_us.items())},
        "idle_ms_per_step_outside_spans":
            idle_us.get(None, 0.0) / steps / 1e3,
    }
    return summary, rows
