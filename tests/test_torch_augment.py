"""The port's train augment (modelcompression_tpu_torch/data/preprocess.py)
against the JAX package's. The random streams differ, so each test
re-derives the JAX function's draws with ``jax.random`` from the same key
and split order as the JAX function, hands them to the port's ``apply_*``
function, and compares images within 1e-6 abs and boxes within 1e-6; the
``sample_*`` draws are checked for range and reproducibility."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.data import preprocess as jp
from modelcompression_tpu_torch.data import preprocess as tp

B, H, W, M = 3, 32, 40, 4
TOL = 1e-6


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    boxes = np.zeros((B, M, 5), np.float32)
    for b in range(B):
        for m in range(3):
            boxes[b, m] = [rng.integers(0, 5), rng.uniform(0.1, 0.9),
                           rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.5),
                           rng.uniform(0.05, 0.5)]
    boxes[:, 1, 3] = 0.0  # an invalid row between valid ones
    return images, boxes


def _close(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_flip_matches_jax(seed):
    images, boxes = _batch(seed)
    key = jax.random.key(seed)
    want = jp.random_flip(jnp.asarray(images), jnp.asarray(boxes), key)
    flip = jax.random.bernoulli(key, 0.5, (B,))
    got = tp.apply_flip(_t(images), _t(boxes), _t(flip))
    _close(got[0], want[0])
    _close(got[1], want[1])
    # uint8 images flip bit for bit (the step's fast path)
    u8 = (images * 255).astype(np.uint8)
    got8 = tp.apply_flip(_t(u8), _t(boxes), _t(flip))[0]
    want8 = jp.random_flip(jnp.asarray(u8), jnp.asarray(boxes), key)[0]
    assert np.array_equal(got8.numpy(), np.asarray(want8))


@pytest.mark.parametrize("jitter,seed", [(0.2, 0), (0.3, 1), (0.45, 2)])
def test_jitter_matches_jax(jitter, seed):
    images, boxes = _batch(seed)
    key = jax.random.key(seed + 10)
    want = jp.random_jitter(jnp.asarray(images), jnp.asarray(boxes), key,
                            jitter=jitter)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = [jax.random.uniform(k, (B,), minval=-jitter, maxval=jitter)
             for k in (k1, k2, k3, k4)]
    got = tp.apply_jitter(_t(images), _t(boxes), *map(_t, draws))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_jitter_identity_at_zero_offsets():
    images, boxes = _batch(3)
    z = torch.zeros(B)
    out, ob = tp.apply_jitter(_t(images), _t(boxes), z, z, z, z)
    _close(out, images)
    _close(ob[..., 1:], np.where(boxes[..., 3:4] > 0, boxes[..., 1:], 0))


@pytest.mark.parametrize("seed", [0, 1])
def test_mosaic_random_center_matches_jax(seed):
    images, boxes = _batch(seed)
    key = jax.random.key(seed + 20)
    want = jp.mosaic4(jnp.asarray(images), jnp.asarray(boxes), key)
    k1, k2 = jax.random.split(key)
    fy = jax.random.uniform(k1, (B,), minval=0.3, maxval=0.7)
    fx = jax.random.uniform(k2, (B,), minval=0.3, maxval=0.7)
    got = tp.apply_mosaic4(_t(images), _t(boxes), _t(fy), _t(fx))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_mosaic_fixed_center_matches_jax():
    images, boxes = _batch(4)
    want = jp.mosaic4(jnp.asarray(images), jnp.asarray(boxes),
                      jax.random.key(0), center_range=None)
    got = tp.mosaic4(_t(images), _t(boxes), None, center_range=None)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_hsv_round_trip_matches_jax():
    images, _ = _batch(5)
    hsv_t = tp.rgb_to_hsv(_t(images))
    _close(hsv_t, jp.rgb_to_hsv(jnp.asarray(images)))
    _close(tp.hsv_to_rgb(hsv_t), jp.hsv_to_rgb(jnp.asarray(hsv_t.numpy())))
    # grey, primaries and a hue wrap (h just below 1)
    special = np.array([[[0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                         [1, 0, 0.001], [0, 0, 0]]], np.float32)
    _close(tp.rgb_to_hsv(_t(special)), jp.rgb_to_hsv(jnp.asarray(special)))


@pytest.mark.parametrize("seed", [0, 1])
def test_distort_hsv_matches_jax(seed):
    images, _ = _batch(seed)
    key = jax.random.key(seed + 30)
    want = jp.distort_hsv(jnp.asarray(images), key, hue=0.1, sat=1.5,
                          expo=1.5)
    k1, k2, k3 = jax.random.split(key, 3)
    d_sat = jax.random.uniform(k1, (B, 1, 1), minval=1 / 1.5, maxval=1.5)
    d_exp = jax.random.uniform(k2, (B, 1, 1), minval=1 / 1.5, maxval=1.5)
    d_hue = jax.random.uniform(k3, (B, 1, 1), minval=-0.1, maxval=0.1)
    got = tp.apply_distort_hsv(_t(images), _t(d_sat), _t(d_exp), _t(d_hue))
    _close(got, want)


def test_samplers_range_and_reproducible():
    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return (tp.sample_flip(64, g), tp.sample_jitter(64, g, 0.3),
                tp.sample_mosaic_center(64, g), tp.sample_hsv(64, g))
    a, b = draws(7), draws(7)
    flat_a = [a[0]] + list(a[1]) + list(a[2]) + list(a[3])
    flat_b = [b[0]] + list(b[1]) + list(b[2]) + list(b[3])
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    flip, jit, (fy, fx), (d_sat, d_exp, d_hue) = a
    assert flip.dtype == torch.bool and 0 < int(flip.sum()) < 64
    assert all(((j >= -0.3) & (j < 0.3)).all() for j in jit)
    assert ((fy >= 0.3) & (fy < 0.7)).all()
    assert ((fx >= 0.3) & (fx < 0.7)).all()
    assert d_sat.shape == (64, 1, 1)
    assert ((d_sat >= 1 / 1.5) & (d_sat < 1.5)).all()
    assert ((d_hue >= -0.1) & (d_hue < 0.1)).all()
    with pytest.raises(ValueError):
        tp.sample_jitter(4, torch.Generator(), 0.5)
    with pytest.raises(ValueError):
        tp.sample_mosaic_center(4, torch.Generator(), (0.0, 0.5))
