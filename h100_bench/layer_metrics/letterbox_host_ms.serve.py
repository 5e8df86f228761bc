"""Mean host milliseconds a batch in the port's ``serve.letterbox`` span
(``evaluation.pipeline``: the device letterbox of the source frames,
issued by the host) over the traced window, per ``serve.step`` span."""

from h100_bench.program_spans import span_ms


def read(run):
    return span_ms(run, "serve.letterbox", "serve.step")
