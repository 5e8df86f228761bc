"""Per-batch readings of spans a program may lack, from the port's
in-memory span log in the process that ran the cell's stream loop.

``program_spans.span_ms`` reads 0 for a span that no program step
opened; here such a span reads as nothing, so that a program older than
the span (or one that never opens it) reports no number.
"""

from __future__ import annotations

from h100_bench.program_spans import span_ms


def logged_span_ms(run, name: str, per: str):
    """``program_spans.span_ms``, or None where no span ``name`` was
    logged (a program that does not open it)."""
    value = span_ms(run, name, per)
    if value is None:
        return None
    from modelcompression_tpu_torch.utils.profiling import span_log
    return value if any(r.name == name for r in span_log()) else None
