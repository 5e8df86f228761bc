"""Mean host milliseconds a batch in the port's ``serve.forward`` span
(``evaluation.pipeline``: the host's dispatch of ``forward_folded``, the
conv stack) over the traced window, per ``serve.step`` span."""

from h100_bench.program_spans import span_ms


def read(run):
    return span_ms(run, "serve.forward", "serve.step")
