"""Step timer, the ``StepTimer`` of ``modelcompression_tpu/utils/
profiling.py`` (whose module imports JAX, so it is copied here):
images per second over steps after a warm-up."""

from __future__ import annotations

import time


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
