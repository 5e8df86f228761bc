"""Mean host milliseconds of one call of the serving step
(``evaluation.pipeline.make_eval_step``'s step) in the window: the
benchmark's span around each call, which returns before the device ends
the batch. The host's dispatch of the step's operations."""


def read(run):
    spans = run["spans"].get("step_enqueue_s") if run["driver"] == "stream" \
        else None
    return 1e3 * sum(spans) / len(spans) if spans else None
