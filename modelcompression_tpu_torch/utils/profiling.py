"""Tracing and profiling helpers, the port's copy of
``modelcompression_tpu/utils/profiling.py`` (whose module imports JAX):
a ``torch.profiler`` trace context, a step timer reporting images per
second, and a non-finite tripwire."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Profile the body with ``torch.profiler`` (CPU and, where a card is
    present, CUDA activity) and write a Chrome trace
    ``trace_dir/trace.json``; a no-op when ``trace_dir`` is unset. Yields
    the profiler (``key_averages()`` for sums by operation), or None."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class StepTimer:
    """Rolling images/sec meter. Call .tick(batch) after each step; warmup
    steps are excluded from the average. On a CUDA device a step returns
    before the device finishes, so read ``images_per_sec`` after a
    synchronisation (a metric copied to the host) for a device rate."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.n_steps = 0
        self.n_images = 0
        self._start = None
        if warmup == 0:  # clock starts immediately; ticks count from step 1
            self._start = time.perf_counter()

    def tick(self, batch_size: int) -> None:
        self.n_steps += 1
        if self.n_steps == self.warmup:
            self._start = time.perf_counter()
            self.n_images = 0
        elif self.n_steps > self.warmup:
            self.n_images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self._start is None or self.n_images == 0:
            return 0.0
        dt = time.perf_counter() - self._start
        return self.n_images / dt if dt > 0 else 0.0


def nan_check(tensors, name: str = "tree") -> None:
    """Debug tripwire: raise ``FloatingPointError`` if a floating tensor
    in ``tensors`` (a tensor, or nested dicts, lists and tuples of them)
    holds a NaN or an Inf. Forces a device synchronization; call
    sparingly."""
    def leaves(t):
        if isinstance(t, dict):
            for k in sorted(t, key=str):
                yield from leaves(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)
        else:
            yield t
    for i, leaf in enumerate(leaves(tensors)):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(
                    f"non-finite values in {name} leaf {i}")
