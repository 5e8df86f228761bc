"""Mean milliseconds a batch the serving loop waited for the feed: the
port's ``feed.wait`` span around the consumer's take from
``data/streaming.prefetch_to_device``'s queue, over the traced window."""

from h100_bench.program_spans import span_ms


def read(run):
    return span_ms(run, "feed.wait", "feed.wait")
