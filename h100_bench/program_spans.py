"""Per-batch means of the port's own spans (``utils.profiling.span``),
read from its in-memory span log in the process that ran the driver.

The spans are logged only while a profiler records on the thread that
opens them, which is the stream driver's ``--trace 1`` window: a
``--trace 0`` run leaves the log empty. A program without the span log
(before the spans were added) reads as nothing, as does a log that
dropped records.
"""

from __future__ import annotations


def span_ms(run, name: str, per: str):
    """Mean milliseconds a batch in the spans called ``name``: their
    summed length over the number of ``per`` spans (one a batch), or None
    where there is nothing to read."""
    if run.get("driver") != "stream" or not run.get("trace"):
        return None
    try:
        from modelcompression_tpu_torch.utils.profiling import (
            span_log, span_log_dropped,
        )
    except ImportError:
        return None
    if span_log_dropped():
        return None
    log = span_log()
    batches = sum(1 for r in log if r.name == per)
    if not batches:
        return None
    return sum(r.end_ns - r.start_ns for r in log
               if r.name == name) / batches / 1e6
