"""The port's spans (``utils.profiling.span``) in the serving step and the
feed, on the CPU: silent and free of ``record_function`` with no profiler,
logged under one, on the profiler's own clock; and the profiler window's
busy and idle arithmetic (``cli._profiling``)."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modelcompression_tpu_torch.cli._profiling import (
    busy_and_idle, merge_intervals,
)
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.data.fixtures import tiny_region_cfg
from modelcompression_tpu_torch.data.streaming import prefetch_to_device
from modelcompression_tpu_torch.evaluation import EvalConfig, make_eval_step
from modelcompression_tpu_torch.models import (
    fold_batchnorm, init_params, parse_cfg,
)
from modelcompression_tpu_torch.utils import profiling

NET, SRC = 64, (48, 80)
# the step's spans in the order they end, each with the span it nests in
CHILDREN = ["serve.letterbox", "serve.forward", "serve.decode", "serve.nms",
            "serve.postprocess"]
PARENT = {"serve.letterbox": "serve.step", "serve.forward": "serve.step",
          "serve.decode": "serve.postprocess",
          "serve.nms": "serve.postprocess",
          "serve.postprocess": "serve.step", "serve.step": None}
# the profiler stamps its ranges in whole microseconds on its own clock,
# converted to the Unix clock the log uses by a linear fit; this covers
# the rounding and the fit, never a stall between the two stamps (a
# stall only widens the range around the logged span)
CLOCK_US = 20


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear_span_log()
    yield
    profiling.clear_span_log()


def _step(src_hw):
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=NET, height=NET))
    params = fold_batchnorm(init_params(spec, seed=0), spec)
    cfg = EvalConfig(conf_thresh=0.01, max_detections=8, nms_prefilter=32,
                     precision=BITMATCH, device="cpu")
    step = make_eval_step(spec, cfg, src_hw=src_hw)
    h, w = src_hw or (NET, NET)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    sizes = np.full(2, float(w), np.float32), np.full(2, float(h),
                                                      np.float32)
    return lambda: step(params, images, *sizes)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_logs_nothing_and_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(profiling, "record_function", refuse)
    _step(SRC)()
    _step(None)()
    assert list(prefetch_to_device(iter(range(3)), device="cpu",
                                   put=lambda x: x)) == [0, 1, 2]
    assert profiling.span_log() == [] and profiling.span_log_dropped() == 0
    with profiling.span("anything") as on:
        assert on is None


@pytest.mark.parametrize("src_hw", [SRC, None],
                         ids=["device_letterbox", "net_canvas"])
def test_each_step_logs_one_step_span_over_three_children(src_hw):
    run = _step(src_hw)
    run()
    with _cpu_profile():
        run()
        run()
    log = profiling.span_log()
    per_call = len(CHILDREN) + 1
    assert [r.name for r in log] == (CHILDREN + ["serve.step"]) * 2
    thread = threading.get_native_id()
    for call in (log[:per_call], log[per_call:]):
        by_name = {r.name: r for r in call}
        assert all(r.thread == thread for r in call)
        for r in call:
            assert r.parent == PARENT[r.name]
            assert r.start_ns <= r.end_ns
            if r.parent is not None:
                up = by_name[r.parent]
                assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
        # siblings one after another, in the order they run
        for parent in ("serve.step", "serve.postprocess"):
            kids = [by_name[n] for n in CHILDREN if PARENT[n] == parent]
            for a, b in zip(kids, kids[1:]):
                assert a.end_ns <= b.start_ns


def test_outputs_equal_with_and_without_spans():
    run = _step(SRC)
    off = run()
    with _cpu_profile():
        on = run()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_logged_spans_match_the_profilers_ranges():
    run = _step(SRC)
    run()
    with _cpu_profile() as prof:
        run()
        run()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in prof.events():
        if e.name.startswith(profiling.SPAN_PREFIX):
            name = e.name[len(profiling.SPAN_PREFIX):]
            ranges.setdefault(name, []).append(
                (e.time_range.start, e.time_range.end))
    log = profiling.span_log()
    assert sorted(ranges) == sorted(CHILDREN + ["serve.step"])
    # each logged span, on the profiler's clock, beside its range: a span
    # stamps its start after entering the range and its end before leaving
    # it, so the range holds the logged span (to the clocks' bound) however
    # long the thread stalls between the two
    pairs = []
    for name, got in ranges.items():
        mine = sorted(((r.start_ns - t0) / 1e3, (r.end_ns - t0) / 1e3)
                      for r in log if r.name == name)
        assert len(mine) == len(got) == 2
        for (ms, me), (ps, pe) in zip(mine, sorted(got)):
            assert ps - CLOCK_US <= ms <= me <= pe + CLOCK_US, name
            pairs.append((name, ms, me, ps, pe))
    # order and nesting exactly as the profiler has them: a range nests in
    # another's where its logged span does, and ends before the next
    # logged span of its thread that it does not hold starts
    for a, ams, ame, aps, ape in pairs:
        for b, bms, bme, bps, bpe in pairs:
            if (a, ams) == (b, bms):
                continue
            if bms <= ams and ame <= bme:
                assert bps <= aps + CLOCK_US and ape <= bpe + CLOCK_US, \
                    (a, b)
            elif ame <= bms:
                assert ape <= bms + CLOCK_US, (a, b)


def test_feed_logs_the_producers_puts_and_the_consumers_waits():
    main = threading.get_native_id()
    producer = []

    def put(x):
        producer.append(threading.get_native_id())
        return x

    feed = prefetch_to_device(iter(range(6)), depth=2, device="cpu",
                              put=put)
    assert next(feed) == 0  # the producer starts outside the profiler
    with _cpu_profile():
        got = [next(feed) for _ in range(4)]
    assert got == [1, 2, 3, 4]
    assert list(feed) == [5]
    log = profiling.span_log()
    waits = [r for r in log if r.name == "feed.wait"]
    puts = [r for r in log if r.name == "feed.put"]
    assert len(waits) == len(puts) == 4
    assert {r.thread for r in waits} == {main}
    assert {r.thread for r in puts} == set(producer) != {main}
    assert all(r.parent is None and r.start_ns <= r.end_ns for r in puts)
    # each put was stamped before the consumer's wait for it ended
    assert all(p.start_ns <= w.end_ns for p, w in zip(puts, waits))


def test_a_full_log_counts_its_drops(monkeypatch):
    monkeypatch.setattr(profiling._LOG, "capacity", 3)
    with _cpu_profile():
        for _ in range(5):
            with profiling.span("x"):
                pass
        profiling.log_span("y", 1, 2, 7)
    assert [r.name for r in profiling.span_log()] == ["x"] * 3
    assert profiling.span_log_dropped() == 3
    profiling.clear_span_log()
    assert profiling.span_log() == [] and profiling.span_log_dropped() == 0


def test_busy_is_the_union_of_overlapping_intervals():
    busy = [(0, 4), (2, 6), (5, 7), (10, 12), (11, 11.5), (20, 30)]
    assert merge_intervals(busy) == [[0, 7], [10, 12], [20, 30]]
    total, idle = busy_and_idle(busy, [], 1, 25)
    # [1, 7] + [10, 12] + [20, 25]: not the sum 4 + 4 + 2 + 2 + 0.5 + 10
    assert total == 13
    assert idle == {None: 11}


def test_idle_goes_to_the_innermost_covering_span():
    busy = [(1, 2), (3, 4), (8, 9)]
    spans = [("step", 0, 10), ("letterbox", 0, 2.5), ("forward", 2.5, 6),
             ("post", 6, 10), ("other", 11, 12)]
    total, idle = busy_and_idle(busy, spans, 0, 12)
    assert total == 3
    assert idle == pytest.approx({"letterbox": 1.5, "forward": 2.5,
                                  "post": 3.0, None: 1.0, "other": 1.0})
    assert sum(idle.values()) + total == 12
