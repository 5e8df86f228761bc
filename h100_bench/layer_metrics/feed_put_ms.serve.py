"""Mean milliseconds a batch of the producer thread's ``put`` in
``data/streaming.prefetch_to_device`` (``to_device``: pin, then enqueue the
copy): the port's ``feed.put`` records of the batches taken in the traced
window, per ``feed.wait`` span."""

from h100_bench.program_spans import span_ms


def read(run):
    return span_ms(run, "feed.put", "feed.wait")
