"""The readers of the port's spans (``layer_metrics/*_ms.serve.py`` over
``program_spans.span_ms``): the mean a batch on a synthetic span log, and
nothing on an empty log, a log that dropped records, or a run that is not
a traced stream run."""

import pytest

from h100_bench import run as harness
from modelcompression_tpu_torch.utils import profiling

MS = 1_000_000  # ns
# two batches: (name, start, end) in ms
LOG = [("feed.put", 0, 3), ("feed.wait", 1, 2), ("serve.letterbox", 2, 3),
       ("serve.forward", 3, 7), ("serve.postprocess", 7, 10),
       ("serve.step", 2, 10),
       ("feed.put", 4, 6), ("feed.wait", 10, 14), ("serve.letterbox", 14, 16),
       ("serve.forward", 16, 22), ("serve.postprocess", 22, 23),
       ("serve.step", 14, 23)]
WANT = {"letterbox_host_ms.serve": 1.5, "forward_host_ms.serve": 5.0,
        "postprocess_host_ms.serve": 2.0, "feed_wait_ms.serve": 2.5,
        "feed_put_ms.serve": 2.5}
TRACED = {"driver": "stream", "trace": {"busy_s": 1.0, "window_s": 2.0}}


@pytest.fixture
def log():
    profiling.clear_span_log()
    for name, s, e in LOG:
        profiling.log_span(name, s * MS, e * MS, 1)
    yield
    profiling.clear_span_log()


@pytest.mark.parametrize("metric", sorted(WANT))
def test_mean_a_batch(log, metric):
    read = harness.load_module("layer_metrics", metric).read
    assert read(TRACED) == pytest.approx(WANT[metric])
    assert read(dict(TRACED, trace=None)) is None
    assert read(dict(TRACED, driver="other")) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_nothing_to_read(metric, monkeypatch):
    read = harness.load_module("layer_metrics", metric).read
    profiling.clear_span_log()
    assert read(TRACED) is None
    monkeypatch.setattr(profiling._LOG, "capacity", 0)
    profiling.log_span("serve.step", 0, MS, 1)
    profiling.log_span("feed.wait", 0, MS, 1)
    assert profiling.span_log_dropped() == 2 and read(TRACED) is None
    profiling.clear_span_log()
