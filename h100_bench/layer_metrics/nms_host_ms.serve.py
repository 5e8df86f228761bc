"""Mean host milliseconds a batch in the port's ``serve.nms`` span
(``evaluation.pipeline``'s post-process: the class-agnostic prefilter and
the per-class NMS) over the traced window, per ``serve.step`` span."""

from h100_bench.logged_spans import logged_span_ms


def read(run):
    return logged_span_ms(run, "serve.nms", "serve.step")
