"""Mean host milliseconds a batch in the port's ``serve.postprocess`` span
(``evaluation.pipeline``: decode, the top-128 prefilter, per-class NMS and
the map to source pixels) over the traced window, per ``serve.step`` span."""

from h100_bench.program_spans import span_ms


def read(run):
    return span_ms(run, "serve.postprocess", "serve.step")
