"""The port's letterbox, decode and NMS against the JAX package's, on the
same numpy inputs.

Tolerances: letterbox fp32 atol 1e-6 (two fp32 matmuls of weights summing
to 1 over [0, 1] pixels; only the summation order differs), bf16 one bf16
ulp at 1.0 (2**-8 relative rounding of values <= 1, plus the matmul's
order); decode rtol 1e-6 (the same elementwise fp32 formulas, library
sigmoid/exp/softmax may differ in the last bit); corners_to_image and NMS
exact (the same IEEE elementwise operations in the same order, and a
stable top-k on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.data import preprocess as jpre
from modelcompression_tpu.evaluation import decode as jdec
from modelcompression_tpu.evaluation import nms as jnms
from modelcompression_tpu.models.cfg import RegionLayer as JRegion
from modelcompression_tpu_torch.data import preprocess as tpre
from modelcompression_tpu_torch.evaluation import decode as tdec
from modelcompression_tpu_torch.evaluation import nms as tnms
from modelcompression_tpu_torch.models.cfg import RegionLayer as TRegion


def _frames(b, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                np.uint8)


@pytest.mark.parametrize("src, net", [((48, 64), (64, 64)),
                                      ((40, 30), (64, 96)),
                                      ((384, 512), (416, 416)),
                                      ((64, 64), (64, 64))])
def test_letterbox_device_fp32_matches_jax(src, net):
    imgs = _frames(2, *src, seed=src[0])
    want = np.asarray(jpre.letterbox_device(jnp.asarray(imgs), *net))
    got = tpre.letterbox_device(torch.from_numpy(imgs), *net)
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_letterbox_device_bf16_matches_jax():
    imgs = _frames(2, 48, 64, seed=3)
    want = np.asarray(jpre.letterbox_device(jnp.asarray(imgs), 64, 64,
                                            dtype=jnp.bfloat16), np.float32)
    got = tpre.letterbox_device(torch.from_numpy(imgs), 64, 64,
                                dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -7,
                               rtol=0)


@pytest.mark.parametrize("src, net", [((48, 64), (64, 64)),
                                      ((40, 30), (32, 32))])
def test_stretch_resize_fp32_matches_jax(src, net):
    imgs = _frames(1, *src, seed=5)
    want = np.asarray(jpre.stretch_resize_device(jnp.asarray(imgs), *net))
    got = tpre.stretch_resize_device(torch.from_numpy(imgs), *net)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("src, dst", [(384, 416), (512, 416), (30, 64),
                                      (7, 7)])
def test_linear_resize_matrix_equal(src, dst):
    np.testing.assert_array_equal(tpre._linear_resize_matrix(src, dst),
                                  jpre._linear_resize_matrix(src, dst))


def test_normalize_matches_jax():
    imgs = _frames(1, 4, 5, seed=6)
    np.testing.assert_array_equal(
        tpre.normalize(torch.from_numpy(imgs)).numpy(),
        np.asarray(jpre.normalize(jnp.asarray(imgs))))


def test_letterbox_host_matches_jax():
    pytest.importorskip("cv2")
    img = _frames(1, 80, 100, seed=7)[0]
    want = jpre.letterbox_host(img, 64, 64)
    got = tpre.letterbox_host(img, 64, 64)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _region(cls, classes=3):
    return cls(anchors=(1.08, 1.19, 3.42, 4.41, 6.63, 11.38, 9.42, 5.11,
                        16.62, 10.52), classes=classes, num=5)


def test_decode_region_matches_jax():
    raw = np.random.default_rng(8).normal(
        0, 2, (2, 4, 5, 5 * (5 + 3))).astype(np.float32)
    want = jdec.decode_region(jnp.asarray(raw), _region(JRegion))
    got = tdec.decode_region(torch.from_numpy(raw), _region(TRegion))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_center_to_corners_matches_jax():
    b = np.random.default_rng(9).uniform(0, 1, (2, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tdec.center_to_corners(torch.from_numpy(b)).numpy(),
        np.asarray(jdec.center_to_corners(jnp.asarray(b))))


@pytest.mark.parametrize("letterboxed", [True, False])
def test_corners_to_image_matches_jax(letterboxed):
    rng = np.random.default_rng(10)
    boxes = rng.uniform(-0.1, 1.1, (4, 3, 5, 4)).astype(np.float32)
    # sizes whose scaled content lands on a .5 (round half to even) and
    # odd pads (floor), plus a square and a portrait image
    w = np.array([500.0, 333.0, 416.0, 300.0], np.float32)
    h = np.array([375.0, 500.0, 416.0, 601.0], np.float32)
    want = np.asarray(jdec.corners_to_image(
        jnp.asarray(boxes), jnp.asarray(w)[:, None, None],
        jnp.asarray(h)[:, None, None], 416, 416, letterboxed))
    got = tdec.corners_to_image(
        torch.from_numpy(boxes), torch.from_numpy(w)[:, None, None],
        torch.from_numpy(h)[:, None, None], 416, 416, letterboxed).numpy()
    np.testing.assert_array_equal(got, want)


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(11)
    a = np.sort(rng.uniform(0, 1, (6, 2, 2)), axis=1).transpose(
        0, 2, 1).reshape(6, 4).astype(np.float32)[:, [0, 2, 1, 3]]
    b = a[::-1].copy()
    np.testing.assert_array_equal(
        tnms.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jnms.pairwise_iou(jnp.asarray(a), jnp.asarray(b))))


def _det_case(b=2, n=60, c=3, seed=0, levels=None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (b, n, 2))
    wh = rng.uniform(0.05, 0.3, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, c)) ** 3
    if levels is not None:  # quantize: many exactly tied scores
        scores = np.round(scores * levels) / levels
    return boxes, scores.astype(np.float32)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k, levels", [(8, None), (32, None), (80, None),
                                       (16, 8), (40, 4)])
def test_batched_per_class_nms_matches_jax(k, levels):
    boxes, scores = _det_case(seed=k, levels=levels)
    want = jnms.batched_per_class_nms(jnp.asarray(boxes),
                                      jnp.asarray(scores), 0.45, 0.01, k)
    got = tnms.batched_per_class_nms(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.45, 0.01, k)
    assert tuple(got[0].shape) == (2, 3, k, 4)
    _assert_same(got, want)


@pytest.mark.parametrize("prefilter, k, levels", [(128, 32, None),
                                                  (20, 8, None),
                                                  (16, 8, 4),
                                                  (64, 16, 8)])
def test_batched_per_class_nms_prefiltered_matches_jax(prefilter, k,
                                                       levels):
    boxes, scores = _det_case(n=90, seed=prefilter + k, levels=levels)
    want = jnms.batched_per_class_nms_prefiltered(
        jnp.asarray(boxes), jnp.asarray(scores), 0.45, 0.01, k,
        prefilter=prefilter)
    got = tnms.batched_per_class_nms_prefiltered(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 0.01, k,
        prefilter=prefilter)
    _assert_same(got, want)


def test_tied_scores_keep_lower_index_first():
    """Five identical, fully overlapping boxes with one tied score: greedy
    (and lax.top_k) keeps the LOWEST index, so the kept box is box 0's
    coordinates; both packages agree on every slot."""
    boxes = np.tile(np.array([[0.1, 0.1, 0.5, 0.5]], np.float32), (5, 1))
    boxes[:, 2] += np.arange(5, dtype=np.float32) * 1e-3  # tell them apart
    scores = np.full((5, 1), 0.7, np.float32)
    got = tnms.per_class_nms(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.45, 0.01, 4)
    want = jnms.per_class_nms(jnp.asarray(boxes), jnp.asarray(scores),
                              0.45, 0.01, 4)
    _assert_same(got, want)
    assert got[2][0].tolist() == [True, False, False, False]
    np.testing.assert_array_equal(got[0][0, 0].numpy(), boxes[0])
    vals, idx = tnms._topk_stable(torch.tensor([0.5, 0.9, 0.5, 0.9, 0.1]),
                                  4)
    assert idx.tolist() == [1, 3, 0, 2]


def _greedy_reference(boxes, scores, iou_thresh, score_thresh):
    """Classic host greedy NMS (numpy): the semantics nms_topk equals
    while at most K candidates clear the threshold."""
    live = [i for i in np.argsort(-scores, kind="stable")
            if scores[i] > score_thresh]
    kept = []
    while live:
        i = live.pop(0)
        kept.append(i)
        iou = tnms.pairwise_iou(torch.from_numpy(boxes[i:i + 1]),
                                torch.from_numpy(boxes[live])).numpy()[0] \
            if live else np.zeros(0)
        live = [j for j, v in zip(live, iou) if v <= iou_thresh]
    return kept


def test_nms_topk_equals_greedy_under_budget():
    boxes, scores = _det_case(b=1, n=40, c=1, seed=12)
    boxes, s = boxes[0], scores[0, :, 0]
    kept = _greedy_reference(boxes, s, 0.45, 0.05)
    assert (s > 0.05).sum() <= 40
    out_b, out_s, valid = tnms.nms_topk(torch.from_numpy(boxes),
                                        torch.from_numpy(s), 0.45, 0.05, 40)
    got = out_s[valid].numpy()
    np.testing.assert_array_equal(got, s[kept])


def test_prefilter_impl_bisect_matches_jax():
    """impl='bisect' (rejected before it was ported) equals the JAX
    package's bisect prefilter, with the prefilter overflowing (90
    candidates, 32 slots) and not."""
    boxes, scores = _det_case(n=90, seed=1)
    for prefilter in (32, 128):
        got = tnms.batched_per_class_nms_prefiltered(
            torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 0.01,
            8, prefilter=prefilter, impl="bisect")
        want = jnms.batched_per_class_nms_prefiltered(
            jnp.asarray(boxes), jnp.asarray(scores), 0.45, 0.01, 8,
            prefilter=prefilter, impl="bisect")
        _assert_same(got, want)
