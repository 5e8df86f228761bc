"""The readers of the port's ``serve.decode`` / ``serve.nms`` spans
(``layer_metrics/*.serve.py`` over ``logged_spans``) and of the forward's
device operations outside its convolutions (``epilogue_ops.serve`` over
``stream_heads``' count): the mean a batch on a planted log or count, and
nothing without a traced stream run, on empty or dropped logs, from a
program that never opens the span, or from a driver that counts
nothing."""

import pytest

from h100_bench import run as harness
from modelcompression_tpu_torch.utils import profiling

MS = 1_000_000  # ns
# two batches: (name, start, end) in ms
LOG = [("serve.letterbox", 0, 1), ("serve.forward", 1, 5),
       ("serve.decode", 5, 6), ("serve.nms", 6, 9),
       ("serve.postprocess", 5, 10), ("serve.step", 0, 10),
       ("serve.letterbox", 10, 11), ("serve.forward", 11, 15),
       ("serve.decode", 15, 18), ("serve.nms", 18, 19),
       ("serve.postprocess", 15, 20), ("serve.step", 10, 20)]
SPANS = {"decode_host_ms.serve": 2.0, "nms_host_ms.serve": 2.0}
TRACED = {"driver": "stream", "trace": {"busy_s": 1.0, "window_s": 2.0}}


def _plant(spans=LOG):
    profiling.clear_span_log()
    for name, s, e in spans:
        profiling.log_span(name, s * MS, e * MS, 1)


@pytest.fixture(autouse=True)
def empty_logs():
    profiling.clear_span_log()
    yield
    profiling.clear_span_log()


def _reader(metric):
    return harness.load_module("layer_metrics", metric).read


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_mean_a_batch(metric):
    _plant()
    read = _reader(metric)
    assert read(TRACED) == pytest.approx(SPANS[metric])
    assert read(dict(TRACED, trace=None)) is None
    assert read(dict(TRACED, driver="other")) is None


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_nothing_to_read(metric, monkeypatch):
    read = _reader(metric)
    assert read(TRACED) is None
    # a program older than the span: the other spans only
    _plant(spans=[r for r in LOG if r[0] not in ("serve.decode",
                                                 "serve.nms")])
    assert read(TRACED) is None
    _plant()
    monkeypatch.setattr(profiling._LOG, "capacity", 0)
    profiling.log_span("serve.step", 0, MS, 1)
    assert read(TRACED) is None


def test_epilogue_ops_a_forward():
    read = _reader("epilogue_ops.serve")
    # one range short of its first launches, as a trace's first may be
    counted = [(688, 110)] + [(700, 110)] * 23
    assert read(dict(TRACED, forward_launches=counted)) == 590
    # untraced, from stream's runs (which count nothing), no ranges
    assert read(dict(TRACED, trace=None, forward_launches=counted)) is None
    assert read(TRACED) is None
    assert read(dict(TRACED, forward_launches=None)) is None
    assert read(dict(TRACED, forward_launches=[])) is None
