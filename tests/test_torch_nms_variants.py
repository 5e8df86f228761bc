"""The port's NMS variants against the JAX package's
(modelcompression_tpu/evaluation/nms.py) and the numpy oracles of the JAX
package's own tests: DIoU-NMS, exact ``nms_padded``, soft-NMS, the approx
prefilter and the bisect prefilter. Mirrors tests/test_nms.py,
test_nms_truncation.py, test_soft_nms.py and test_diou_nms.py.

Tolerances: selections (valid masks, boxes, greedy scores) must be EQUAL:
both sides run the same IEEE elementwise ops in the same order and stable
sorts. Soft-NMS scores are products of ``exp`` values, whose last bit may
differ between XLA and ATen on the CPU: within 1e-6 relative. The bisect
prefilter's keep-set must equal JAX's ``segmented_rank_mask`` rule,
including overflow (more live candidates than N'), ties at the N'-th
value and images with fewer than N' live candidates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.evaluation import nms as jnms
from modelcompression_tpu_torch.evaluation import nms as tnms
from tests.test_diou_nms import np_diou_greedy
from tests.test_nms import np_greedy_nms, random_boxes
from tests.test_soft_nms import np_soft_nms

SOFT_RTOL = 1e-6


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _det_case(b=2, n=60, c=3, seed=0, levels=None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (b, n, 2))
    wh = rng.uniform(0.05, 0.3, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, c)) ** 3
    if levels is not None:  # quantize: many exactly tied scores
        scores = np.round(scores * levels) / levels
    return boxes, scores.astype(np.float32)


# ---- DIoU helpers and both greedy paths --------------------------------

@pytest.mark.parametrize("beta", [1.0, 0.6])
def test_diou_penalties_match_jax(beta):
    rng = np.random.default_rng(3)
    a, b = random_boxes(rng, 7), random_boxes(rng, 9)
    np.testing.assert_array_equal(
        tnms.iou_corners(*_t(a[2], b)).numpy(),
        np.asarray(jnms.iou_corners(*_j(a[2], b))))
    np.testing.assert_allclose(
        tnms.diou_penalty(*_t(a[2], b), beta).numpy(),
        np.asarray(jnms.diou_penalty(*_j(a[2], b), beta)), rtol=1e-6)
    np.testing.assert_allclose(
        tnms.pairwise_diou_penalty(*_t(a, b), beta).numpy(),
        np.asarray(jnms.pairwise_diou_penalty(*_j(a, b), beta)), rtol=1e-6)
    # the one-box form is a row of the pairwise form (pow's vectorized
    # and scalar loops may differ in the last bit)
    np.testing.assert_allclose(
        tnms.diou_penalty(*_t(a[2], b), beta).numpy(),
        tnms.pairwise_diou_penalty(*_t(a, b), beta).numpy()[2], rtol=1e-6)


@pytest.mark.parametrize("path", ["padded", "topk"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diou_nms_matches_oracle_and_jax(path, seed):
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, 40)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    fn_t = tnms.nms_padded if path == "padded" else tnms.nms_topk
    fn_j = jnms.nms_padded if path == "padded" else jnms.nms_topk
    got = fn_t(*_t(boxes, scores), 0.4, 0.1, max_out=40, diou=True)
    want = fn_j(*_j(boxes, scores), 0.4, 0.1, max_out=40, diou=True)
    _assert_same(got, want)
    keep = np_diou_greedy(boxes, scores, 0.4, 0.1)
    np.testing.assert_array_equal(got[1][got[2]].numpy(), scores[keep])


@pytest.mark.parametrize("beta", [0.6, 1.0])
@pytest.mark.parametrize("k, levels", [(8, None), (32, None), (16, 4)])
def test_batched_diou_per_class_matches_jax(beta, k, levels):
    boxes, scores = _det_case(seed=k, levels=levels)
    got = tnms.batched_per_class_nms(*_t(boxes, scores), 0.45, 0.01, k,
                                     diou=True, diou_beta=beta)
    want = jnms.batched_per_class_nms(*_j(boxes, scores), 0.45, 0.01, k,
                                      diou=True, diou_beta=beta)
    _assert_same(got, want)


def test_diou_spares_distant_equal_overlap():
    """Two pairs with equal IoU against the pick: DIoU spares the one
    whose center lies farther away (tests/test_diou_nms.py's scene)."""
    boxes = np.array([[0.0, 0.0, 0.4, 0.4],
                      [0.0, 0.3, 0.4, 0.7],
                      [0.3, 0.0, 0.7, 0.4]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    for diou in (False, True):
        got = tnms.nms_padded(*_t(boxes, scores), 0.1, 0.0, max_out=3,
                              diou=diou)
        want = jnms.nms_padded(*_j(boxes, scores), 0.1, 0.0, max_out=3,
                               diou=diou)
        _assert_same(got, want)
    assert int(got[2].sum()) == 3


# ---- exact nms_padded --------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_nms_padded_matches_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, 50)
    scores = rng.uniform(0, 1, 50).astype(np.float32)
    got = tnms.nms_padded(*_t(boxes, scores), 0.45, 0.2, max_out=50)
    _assert_same(got, jnms.nms_padded(*_j(boxes, scores), 0.45, 0.2,
                                      max_out=50))
    keep = np_greedy_nms(boxes, scores, 0.45, 0.2)
    np.testing.assert_array_equal(got[1][got[2]].numpy(), scores[keep])


def test_nms_padded_exact_beyond_k_where_topk_truncates():
    """More candidates than K survive: the exact path equals the oracle,
    the top-k path keeps greedy over the K best (test_nms_truncation)."""
    from tests.test_nms_truncation import _overflow_scene
    boxes, scores = _overflow_scene(n=60, k=8)
    want = np_greedy_nms(boxes, scores, 0.45, 0.1)
    assert len(want) > 8
    got = tnms.nms_padded(*_t(boxes, scores), 0.45, 0.1, max_out=60)
    np.testing.assert_array_equal(got[1][got[2]].numpy(), scores[want])
    top = tnms.nms_topk(*_t(boxes, scores), 0.45, 0.1, max_out=8)
    np.testing.assert_array_equal(top[1][top[2]].numpy(),
                                  np.sort(scores)[-8:][::-1])


@pytest.mark.parametrize("diou", [False, True])
@pytest.mark.parametrize("k, levels", [(8, None), (24, 4)])
def test_batched_per_class_nms_padded_matches_jax(diou, k, levels):
    boxes, scores = _det_case(n=45, seed=k + 5, levels=levels)
    got = tnms.batched_per_class_nms_padded(*_t(boxes, scores), 0.45, 0.01,
                                            k, diou=diou, diou_beta=0.6)
    want = jnms.batched_per_class_nms_padded(*_j(boxes, scores), 0.45,
                                             0.01, k, diou=diou,
                                             diou_beta=0.6)
    assert tuple(got[0].shape) == (2, 3, k, 4)
    _assert_same(got, want)


def test_nms_padded_all_below_threshold():
    boxes = random_boxes(np.random.default_rng(0), 5)
    scores = np.full(5, 0.05, np.float32)
    sel, sc, valid = tnms.nms_padded(*_t(boxes, scores), 0.45, 0.1,
                                     max_out=4)
    assert not valid.any() and not sc.any() and not sel.any()


# ---- exact_prefilter=False (the JAX package's approx prefilter) ----------

@pytest.mark.parametrize("n, k", [(300, 8), (600, 32), (100, 32)])
def test_approx_prefilter_equals_exact_and_jax(n, k):
    """False selects the exact sort here, as JAX's approx_max_k does on
    the CPU, so both equal the exact path."""
    rng = np.random.default_rng(n + k)
    boxes = random_boxes(rng, n)
    scores = np.round(rng.uniform(0, 1, n) * 16).astype(np.float32) / 16
    exact = tnms.nms_topk(*_t(boxes, scores), 0.45, 0.05, k)
    approx = tnms.nms_topk(*_t(boxes, scores), 0.45, 0.05, k,
                           exact_prefilter=False)
    _assert_same(approx, [e.numpy() for e in exact])
    _assert_same(approx, jnms.nms_topk(*_j(boxes, scores), 0.45, 0.05, k,
                                       exact_prefilter=False))


def test_batched_approx_prefiltered_matches_jax():
    boxes, scores = _det_case(n=700, c=2, seed=4, levels=8)
    for impl in ("topk", "bisect"):
        got = tnms.batched_per_class_nms_prefiltered(
            *_t(boxes, scores), 0.45, 0.01, 8, prefilter=300,
            exact_prefilter=False, impl=impl)
        want = jnms.batched_per_class_nms_prefiltered(
            *_j(boxes, scores), 0.45, 0.01, 8, prefilter=300,
            exact_prefilter=False, impl=impl)
        _assert_same(got, want)


# ---- soft-NMS ----------------------------------------------------------

def _assert_soft(got, want):
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=SOFT_RTOL)


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soft_nms_matches_oracle_and_jax(linear, seed):
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, 30)
    scores = rng.uniform(0, 1, 30).astype(np.float32)
    got = tnms.soft_nms_topk(*_t(boxes, scores), 0.3, 0.05, max_out=30,
                             sigma=0.5, linear=linear)
    _assert_soft(got, jnms.soft_nms_topk(*_j(boxes, scores), 0.3, 0.05,
                                         max_out=30, sigma=0.5,
                                         linear=linear))
    want = np_soft_nms(boxes, scores, 0.3, 0.05, 0.5, linear)
    v = got[2].numpy()
    assert v.sum() == len(want)
    np.testing.assert_allclose(got[1].numpy()[v], [s for _, s in want],
                               rtol=1e-5)
    np.testing.assert_array_equal(got[0].numpy()[v],
                                  boxes[[i for i, _ in want]])


@pytest.mark.parametrize("linear, sigma", [(False, 0.5), (False, 0.3),
                                           (True, 0.5)])
@pytest.mark.parametrize("k", [4, 16, 80])
def test_batched_soft_nms_matches_jax(linear, sigma, k):
    boxes, scores = _det_case(seed=k + 1)
    got = tnms.batched_per_class_soft_nms(*_t(boxes, scores), 0.3, 0.01, k,
                                          sigma=sigma, linear=linear)
    want = jnms.batched_per_class_soft_nms(*_j(boxes, scores), 0.3, 0.01,
                                           k, sigma=sigma, linear=linear)
    assert tuple(got[0].shape) == (2, 3, k, 4)
    _assert_soft(got, want)


def test_soft_nms_non_overlapping_keep_scores():
    boxes = np.array([[0.0, 0.0, 0.1, 0.1], [0.5, 0.5, 0.6, 0.6],
                      [0.8, 0.0, 0.9, 0.1]], np.float32)
    scores = np.array([0.3, 0.9, 0.6], np.float32)
    _, sc, valid = tnms.soft_nms_topk(*_t(boxes, scores), 0.3, 0.01, 5)
    np.testing.assert_array_equal(sc.numpy()[:3], scores[[1, 2, 0]])
    assert valid.tolist() == [True, True, True, False, False]


# ---- the bisect prefilter ----------------------------------------------

def _prefilter_case(b, n, c, seed, live=None, levels=None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (b, n, 2))
    wh = rng.uniform(0.05, 0.3, (b, n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, (b, n, c))
    if levels is not None:
        scores = np.round(scores * levels) / levels
    if live is not None:  # only `live` candidates per image above 0.1
        scores = np.where(scores > 0.1, 0.05, scores)
        for i in range(b):
            hot = rng.choice(n, live, replace=False)
            scores[i, hot, rng.integers(0, c, live)] = rng.uniform(
                0.2, 1.0, live)
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("case", [
    # (b, n, c, prefilter, live, levels)
    (3, 200, 6, 128, 80, None),    # within budget
    (2, 97, 3, 24, None, None),    # overflow, tie-free
    (2, 150, 4, 32, None, 8),      # overflow with ties at the N'-th value
    (2, 120, 3, 40, 10, None),     # fewer live than N': zeros are the kth
    (2, 64, 2, 64, None, 4),       # N' == N: keep all
    (1, 50, 5, 200, None, None),   # N' > N
])
def test_bisect_prefilter_matches_jax(case):
    b, n, c, prefilter, live, levels = case
    boxes, scores = _prefilter_case(b, n, c, seed=n + prefilter, live=live,
                                    levels=levels)
    got = tnms.batched_bisect_prefilter(*_t(boxes, scores), 0.1, prefilter)
    want = jnms.batched_bisect_prefilter(*_j(boxes, scores), 0.1, prefilter)
    _assert_same(got, want)
    got = tnms.batched_per_class_nms_prefiltered(
        *_t(boxes, scores), 0.45, 0.1, 16, prefilter=prefilter,
        impl="bisect")
    want = jnms.batched_per_class_nms_prefiltered(
        *_j(boxes, scores), 0.45, 0.1, 16, prefilter=prefilter,
        impl="bisect")
    _assert_same(got, want)


def test_bisect_equals_topk_within_budget():
    """At most N' live candidates per image: the bisect and top-k
    prefilters and the unfiltered path give the same NMS."""
    boxes, scores = _prefilter_case(3, 200, 6, seed=9, live=80)
    args = (*_t(boxes, scores), 0.45, 0.1, 16)
    topk = tnms.batched_per_class_nms_prefiltered(*args, prefilter=128)
    bis = tnms.batched_per_class_nms_prefiltered(*args, prefilter=128,
                                                 impl="bisect")
    base = tnms.batched_per_class_nms(*args)
    _assert_same(bis, [t.numpy() for t in topk])
    _assert_same(bis, [t.numpy() for t in base])
    with pytest.raises(ValueError, match="impl"):
        tnms.batched_per_class_nms_prefiltered(*args, impl="bogus")


def test_bisect_prefilter_tie_rule_keeps_highest_indices():
    """All candidates tied: the bisection drops the lowest indices first
    (so it keeps the highest), the top-k prefilter keeps the lowest;
    survivors come in candidate-index order."""
    n, keep = 10, 4
    boxes = random_boxes(np.random.default_rng(0), n)[None]
    scores = np.full((1, n, 1), 0.5, np.float32)
    b2, cs2 = tnms.batched_bisect_prefilter(*_t(boxes, scores), 0.1, keep)
    np.testing.assert_array_equal(b2[0].numpy(), boxes[0, n - keep:])
    assert (cs2 == 0.5).all()
    jb2, _ = jnms.batched_bisect_prefilter(*_j(boxes, scores), 0.1, keep)
    np.testing.assert_array_equal(b2.numpy(), np.asarray(jb2))


def test_bisect_prefilter_fewer_live_than_budget_zeroes_the_rest():
    """tau == 0 (the N'-th value is a thresholded zero): every live
    candidate survives, the padding slots' class scores are zero."""
    boxes, scores = _prefilter_case(2, 60, 3, seed=5, live=7)
    _, cs2 = tnms.batched_bisect_prefilter(*_t(boxes, scores), 0.1, 20)
    m = cs2.numpy().max(-1)
    for i in range(2):
        live = np.sort(scores[i].max(-1)[scores[i].max(-1) > 0.1])
        np.testing.assert_array_equal(np.sort(m[i][m[i] > 0]), live)
        assert (m[i] > 0).sum() == 7
