"""The port's region loss (modelcompression_tpu_torch/train/region_loss.py)
against the JAX package's on the same numpy inputs: every metric and
d(loss)/d(raw), fp32, 1e-5 relative, across bias_match 0/1, rescore 0/1,
softmax 0/1, the seen gate of the prior loss, duplicate (cell, anchor)
GTs (the later row wins) and invalid rows; plus the detection_loss
dispatch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.models.cfg import RegionLayer as JaxRegionLayer
from modelcompression_tpu.train.region_loss import region_loss as jax_loss
from modelcompression_tpu_torch.data.fixtures import (
    tiny_region_cfg, tiny_yolo3_cfg,
)
from modelcompression_tpu_torch.models import parse_cfg
from modelcompression_tpu_torch.models.cfg import RegionLayer
from modelcompression_tpu_torch.train import detection_loss, region_loss
from modelcompression_tpu_torch.train.yolo_loss import yolo_loss
from modelcompression_tpu_torch.train.region_loss import PRIOR_SEEN_CUTOFF

A, C, H, W, B, M = 3, 4, 5, 6, 2, 6
ANCHORS = (1.0, 1.2, 2.5, 3.0, 4.2, 1.9)
RTOL = 1e-5


def _region(**kw):
    base = dict(anchors=ANCHORS, classes=C, num=A, thresh=0.6,
                object_scale=5.0, noobject_scale=1.0, class_scale=1.0,
                coord_scale=1.0)
    base.update(kw)
    return RegionLayer(**base), JaxRegionLayer(**base)


def _inputs(seed):
    """Random raw map and targets: valid boxes, invalid (w == 0) rows in
    between, and two valid rows on the same cell wanting the same anchor
    (a duplicate the later row must win)."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 1.5, (B, H, W, A * (5 + C))).astype(np.float32)
    t = np.zeros((B, M, 5), np.float32)
    for b in range(B):
        for m in (0, 2, 3):
            t[b, m] = [rng.integers(0, C), rng.uniform(0.05, 0.95),
                       rng.uniform(0.05, 0.95), rng.uniform(0.05, 0.6),
                       rng.uniform(0.05, 0.6)]
    # row 4 duplicates row 2's cell and (nearly) its shape; row 5 invalid
    t[:, 4] = t[:, 2] + np.array([1, 0.001, 0.001, 0.002, 0.002],
                                 np.float32)
    t[:, 4, 0] = (t[:, 2, 0] + 1) % C
    t[:, 1] = [2, 0.5, 0.5, 0.0, 0.3]  # invalid: w == 0
    return raw, t


def _torch_run(raw, t, region, seen):
    r = torch.from_numpy(raw).requires_grad_(True)
    m = region_loss(r, torch.from_numpy(t), region, seen)
    m.loss.backward()
    return ({k: float(v.detach()) for k, v in m.as_dict().items()},
            r.grad.numpy())


_JAX_STEPS = {}  # repr(region) -> the jitted loss and gradient


def _jax_run(raw, t, region, seen):
    """The JAX loss's metrics and d(loss)/d(raw), jitted once per region
    config (the region closed over; raw, targets and seen traced)."""
    key = repr(region)
    if key not in _JAX_STEPS:
        def both(r, tt, s):
            m = jax_loss(r, tt, region, s)
            g = jax.grad(lambda r_: jax_loss(r_, tt, region, s).loss)(r)
            return m.as_dict(), g
        _JAX_STEPS[key] = jax.jit(both)
    m, g = _JAX_STEPS[key](jnp.asarray(raw), jnp.asarray(t),
                           jnp.asarray(seen))
    return {k: float(v) for k, v in m.items()}, np.asarray(g)


def _check(got, want):
    (gm, gg), (wm, wg) = got, want
    assert set(gm) == set(wm)
    for k in wm:
        assert gm[k] == pytest.approx(wm[k], rel=RTOL, abs=1e-6), k
    scale = np.abs(wg).max()
    assert np.abs(gg - wg).max() <= RTOL * scale, np.abs(gg - wg).max()


@pytest.mark.parametrize("bias_match", [1, 0])
@pytest.mark.parametrize("rescore", [1, 0])
@pytest.mark.parametrize("softmax", [1, 0])
def test_region_loss_matches_jax(bias_match, rescore, softmax):
    tr, jr = _region(bias_match=bool(bias_match), rescore=bool(rescore),
                     softmax=bool(softmax))
    raw, t = _inputs(seed=bias_match + 2 * rescore + 4 * softmax)
    seen = PRIOR_SEEN_CUTOFF + 1
    _check(_torch_run(raw, t, tr, seen), _jax_run(raw, t, jr, seen))


@pytest.mark.parametrize("seen", [0, PRIOR_SEEN_CUTOFF - 1,
                                  PRIOR_SEEN_CUTOFF])
def test_prior_gate_matches_jax(seen):
    tr, jr = _region()
    raw, t = _inputs(seed=11)
    got, want = _torch_run(raw, t, tr, seen), _jax_run(raw, t, jr, seen)
    _check(got, want)
    # the gate is what moves the total: on below the cutoff, off at it
    off = _torch_run(raw, t, tr, PRIOR_SEEN_CUTOFF + 5)[0]["loss"]
    assert (got[0]["loss"] > off) == (seen < PRIOR_SEEN_CUTOFF)


def test_duplicate_rows_and_no_gt_match_jax():
    """The duplicate pair lands on one (cell, anchor): the later row's
    class is the one trained. With no valid row (and with no GT slot at
    all) only the no-object and prior terms remain."""
    tr, jr = _region(softmax=True)
    raw, t = _inputs(seed=5)
    got = _torch_run(raw, t, tr, PRIOR_SEEN_CUTOFF + 1)
    _check(got, _jax_run(raw, t, jr, PRIOR_SEEN_CUTOFF + 1))
    assert got[0]["n_gt"] == 2 * 4  # 3 boxes + the duplicate, per image
    g = got[1].reshape(B, H, W, A, 5 + C)
    gi, gj = int(t[0, 2, 1] * W), int(t[0, 2, 2] * H)
    cls_grad = g[0, gj, gi, :, 5:]
    # d CE / d logit of the later row's class is negative (pulled up)
    row = np.nonzero(np.abs(cls_grad).sum(-1))[0]
    assert len(row) == 1
    assert cls_grad[row[0], int(t[0, 4, 0])] < 0
    for empty in (np.zeros((B, M, 5), np.float32),
                  np.zeros((B, 0, 5), np.float32)):
        e_got = _torch_run(raw, empty, tr, 0)
        _check(e_got, _jax_run(raw, empty, jr, 0))
        assert e_got[0]["loss_coord"] == 0 and e_got[0]["n_gt"] == 0


def test_detection_loss_dispatch():
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=64, height=64))
    raw = torch.zeros((1, 2, 2, 5 * 8))
    t = torch.zeros((1, 2, 5))
    a = detection_loss(raw, t, spec, 0)
    b = region_loss(raw, t, spec.region, 0)
    assert all(torch.equal(x, y) for x, y in zip(
        dataclasses.astuple(a), dataclasses.astuple(b)))
    # [yolo] specs go to the multi-head loss over the tuple of raw maps
    v3 = parse_cfg(tiny_yolo3_cfg(num_classes=3))
    raws = [torch.zeros((1, g, g, 2 * 8)) for g in (8, 16)]
    a = detection_loss(raws, t, v3, 0)
    b = yolo_loss(raws, t, v3)
    assert all(torch.equal(x, y) for x, y in zip(
        dataclasses.astuple(a), dataclasses.astuple(b)))
