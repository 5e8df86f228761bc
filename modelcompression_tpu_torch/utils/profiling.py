"""Tracing and profiling helpers, the port's copy of
``modelcompression_tpu/utils/profiling.py`` (whose module imports JAX):
the program's spans, a step timer reporting images per second, and a
non-finite tripwire.

Spans. ``with span("serve.step"):`` marks a stretch of host work. With no
``torch.profiler`` recording on the calling thread it costs one flag
check and enters a shared no-op context. Under a profiler it enters
``record_function("mc.<name>")``, so the stretch shows in the trace on
the clock of the device's kernels and copies, and appends a
``SpanRecord`` to a bounded in-memory log (``span_log``), stamped on that
clock (``now_ns``: the Unix time the profiler stamps its events with).
Nothing is written out on the way; readers take the log at the end.
A thread started before the profiler is outside it (the flag reads False
there): such a thread stamps its own work with ``now_ns`` and hands the
stamps to one inside it, which logs them with ``log_span``.
"""

from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

SPAN_PREFIX = "mc."
# records the log keeps; later ones are counted as dropped
SPAN_LOG_CAPACITY = 1 << 16

now_ns = time.time_ns


class SpanRecord(NamedTuple):
    """One span: its name, the name of the span open around it on the same
    thread (None at the top), the thread's native id, and its start and
    end on ``now_ns``'s clock."""
    name: str
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int


class _SpanLog:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, record: SpanRecord) -> None:
        with self.lock:
            if len(self.records) < self.capacity:
                self.records.append(record)
            else:
                self.dropped += 1


_LOG = _SpanLog(SPAN_LOG_CAPACITY)
_open = threading.local()  # each thread's stack of open span names


class _Span:
    __slots__ = ("name", "parent", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = record_function(SPAN_PREFIX + self.name)
        self.range.__enter__()
        self.start = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
        self.range.__exit__(*exc)
        _open.stack.pop()
        _LOG.add(SpanRecord(self.name, self.parent, threading.get_native_id(),
                            self.start, end))
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context marking host work as span ``name`` (entered, it gives the
    open span, or None where no profiler records on this thread)."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _Span(name)


def log_span(name: str, start_ns: int, end_ns: int, thread: int) -> None:
    """Log a span another thread stamped with ``now_ns`` (no parent: spans
    nest on one thread)."""
    _LOG.add(SpanRecord(name, None, thread, start_ns, end_ns))


def span_log() -> List[SpanRecord]:
    """The spans logged so far, in the order they ended."""
    with _LOG.lock:
        return list(_LOG.records)


def span_log_dropped() -> int:
    """Spans not logged because the log was full."""
    return _LOG.dropped


def clear_span_log() -> None:
    """Empty the log and its count of drops."""
    with _LOG.lock:
        _LOG.records.clear()
        _LOG.dropped = 0


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
