"""Host -> device streaming, port of ``modelcompression_tpu/data/streaming.py``.

A background thread prepares host batches (image decode, letterbox,
collate: the work that cannot run on the device) and copies them to the
device a fixed depth ahead, so the host work for batch i+1 overlaps the
compute of batch i. The consumer sees device tensors.

On a CUDA device the producer copies from pinned host memory, without
blocking the host, on the consumer's own stream (the current stream when
``prefetch_to_device`` is called): every kernel the consumer queues after
it sees a batch is ordered behind that batch's copies, so no copy is read
before it lands.

Spans (``utils.profiling``): ``feed.wait``, the consumer's wait for the
next item, and ``feed.put``, the producer's ``put`` of that item.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

import numpy as np
import torch

from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.utils.profiling import log_span, now_ns, span

T = TypeVar("T")

_STOP = object()


def _tree_map(fn, item):
    """``fn`` on every tensor and ndarray leaf of nested tuples, lists and
    dicts; other leaves are passed through."""
    if isinstance(item, (torch.Tensor, np.ndarray)):
        return fn(item)
    if isinstance(item, (tuple, list)):
        return type(item)(_tree_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    return item


def to_device(item, device: torch.device):
    """Copy every array leaf of ``item`` to ``device``; on CUDA from pinned
    memory and without blocking the host."""
    def put_one(x):
        t = torch.as_tensor(x)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return _tree_map(put_one, item)


def prefetch_to_device(host_batches: Iterable[T], depth: int = 2,
                       device=None,
                       put: Optional[Callable[[T], T]] = None) -> Iterator[T]:
    """Iterate ``host_batches`` with a background thread running ``put``
    (default: ``to_device`` of every array leaf) ``depth`` items ahead.

    ``device``: where the default ``put`` copies to, resolved by the
    port's device rule (``None`` means CUDA, an error without a card).
    ``depth=2`` is double buffering: one batch in flight while one
    executes. Exceptions in the producer (including in the underlying
    iterable) are re-raised at the consumer's next step.
    """
    device = resolve_device(device)
    if put is None:
        def put(item):
            return to_device(item, device)
    consumer = (torch.cuda.current_stream(device) if device.type == "cuda"
                else None)

    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    err = []

    def q_put(item) -> bool:
        """A put that gives up once the consumer abandoned the iterator,
        so an early exit does not leave this thread blocked forever
        holding device buffers."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def put_on_consumer_stream(item):
        if consumer is None:
            return put(item)
        with torch.cuda.stream(consumer):
            return put(item)

    def feeder():
        # each put goes with its stamps, which the consumer logs as a
        # ``feed.put`` span: a thread started before the profiler is
        # outside it
        thread = threading.get_native_id()
        try:
            for item in host_batches:
                if stop.is_set():
                    return
                start = now_ns()
                item = put_on_consumer_stream(item)
                if not q_put((item, start, now_ns(), thread)):
                    return
        except BaseException as e:  # surface in the consumer
            err.append(e)
        finally:
            q_put(_STOP)

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        while True:
            with span("feed.wait") as traced:
                got = q.get()
            if got is _STOP:
                if err:
                    raise err[0]
                return
            item, start, end, thread = got
            if traced is not None:
                log_span("feed.put", start, end, thread)
            yield item
    finally:
        # unblock and end the feeder on early exit, and wait for the item
        # it is making: a daemon thread still inside a torch op when the
        # interpreter exits can abort the process (a training rank that
        # returns while the loader prefetches)
        stop.set()
        t.join()
