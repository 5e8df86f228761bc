"""The traced window: a ``torch.profiler`` run over a fixed number of
steps, reduced to device busy time, device time by operation and the
device's idle gaps by what the host was doing.

Host spans are the benchmark's own ``record_function`` ranges, named
``bench.<what>``. Busy time is the union of the device operations'
intervals (kernels, copies, sets) inside the window, which runs from the
first host span's start to the last one's end (the last span ends on a
device sync).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Tuple

import torch

SPAN_PREFIX = "bench."


def span(name: str):
    """A host span in the traced window (a no-op cost when not tracing)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events) -> Dict:
    """Reduce profiler events to the window's numbers, in seconds."""
    from torch.autograd import DeviceType
    host, device = [], []
    for e in events:
        name = e.name
        start, end = e.time_range.start, e.time_range.end
        if name.startswith(SPAN_PREFIX):
            if e.device_type == DeviceType.CPU:
                host.append((name[len(SPAN_PREFIX):], start, end))
        elif e.device_type == DeviceType.CUDA and end > start \
                and not getattr(e, "is_user_annotation", False):
            device.append((name, start, end))
    if not host:
        raise RuntimeError("traced window has no host spans")
    lo = min(s for _, s, _ in host)
    hi = max(e for _, _, e in host)
    ops: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    clipped = []
    for name, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            clipped.append((s, e))
            ops[name][0] += (e - s) * 1e-6
            ops[name][1] += 1
    merged = _merge(clipped)
    busy = sum(e - s for s, e in merged)
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [lo] + [v for iv in merged for v in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        covering = [(hs, name) for name, hs, he in host if hs <= mid <= he]
        label = max(covering)[1] if covering else "between spans"
        gaps[label] += (e - s) * 1e-6
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "ops": {k: tuple(v) for k, v in ops.items()},
            "gaps": dict(gaps)}


def traced(run: Callable[[], None]) -> Dict:
    """Run ``run`` (which opens its own spans and ends on a device sync)
    under the profiler; returns ``summarize``'s reduction."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    return summarize(prof.events())


def breakdown(summary: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations with
    most time and the ten host spans with most device idle time under
    them, in seconds."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def op_time(summary: Dict, needle: str) -> Tuple[float, int]:
    """Device seconds and launches of the operations whose name holds
    ``needle``."""
    total, count = 0.0, 0
    for name, (sec, n) in summary["ops"].items():
        if needle in name:
            total += sec
            count += n
    return total, count
