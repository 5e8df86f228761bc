"""The check catches a broken timed path. Each test drives a run of a
cell's loop on the CPU at toy size (past the harness's look for a card),
with the port's path broken underneath, and sees ``correct`` come out
false under the cell's own limits."""

import os
import time

import pytest

from h100_bench import run as harness

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "testdata", "tiny-region.cfg")
SEED = 2 ** 31 + 23


def _stream_run():
    cell, _, traffic = harness.load_cell("yolov2-p75-stream")
    traffic = dict(traffic, batch=4, src_h=48, src_w=64, pool=12,
                   warmup_batches=1, check_batches=2)
    out = harness.load_module("drivers", "stream").run(
        cell=cell, config={"cfg": TINY}, traffic=traffic, seed=SEED,
        seconds=3.0, trace=False, t0=time.monotonic(), device="cpu")
    assert out["notes"]["batches_compared"] >= 1
    return harness.check_lines(out)[0]


def _break_step(monkeypatch, fault):
    import modelcompression_tpu_torch.evaluation as ev
    make = ev.make_eval_step

    def broken(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            sel, scores, valid, n_cand, n_any = step(*args)
            return (sel, *fault(scores.clone(), valid.clone()), n_cand,
                    n_any)
        return run
    monkeypatch.setattr(ev, "make_eval_step", broken)


def _half_left_out(scores, valid):
    """Every other row of the batch served without detections (so a
    padded batch loses half of its real rows too)."""
    valid[1::2] = False
    return scores * valid, valid


def _answer_altered(scores, valid):
    scores[:, 0, 0] *= 1.5
    return scores, valid


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered],
                         ids=["half_the_batch_left_out", "answer_altered"])
def test_stream_fault_is_caught(monkeypatch, fault):
    _break_step(monkeypatch, fault)
    assert _stream_run() is False


def _nms_off(orig):
    """Greedy NMS that suppresses nothing."""
    def nms_topk(boxes, scores, iou_thresh, *rest):
        return orig(boxes, scores, 2.0, *rest)
    return nms_topk


def _top_one(orig):
    """Each class's top 1 candidate kept in place of its top K."""
    from modelcompression_tpu_torch.evaluation.nms import _pad_slots

    def nms_topk(boxes, scores, iou_thresh, score_thresh, max_out, *rest):
        out = orig(boxes, scores, iou_thresh, score_thresh, 1, *rest)
        return _pad_slots(*out, 1, max_out)
    return nms_topk


@pytest.mark.parametrize("fault", [_nms_off, _top_one],
                         ids=["nms_switched_off", "k_cut_to_1"])
def test_stream_nms_fault_is_caught(monkeypatch, fault):
    import modelcompression_tpu_torch.evaluation.nms as nms
    monkeypatch.setattr(nms, "nms_topk", fault(nms.nms_topk))
    assert _stream_run() is False


def test_sound_run_is_correct():
    """The same toy run with nothing broken passes the same limits, so
    the faults above are what the check catches."""
    assert _stream_run() is True
