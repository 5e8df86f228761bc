"""Mean host milliseconds a batch in the port's ``serve.decode`` span
(``evaluation.pipeline``'s post-process: ``decode_heads``, the class
scores and the corner boxes) over the traced window, per ``serve.step``
span."""

from h100_bench.logged_spans import logged_span_ms


def read(run):
    return logged_span_ms(run, "serve.decode", "serve.step")
