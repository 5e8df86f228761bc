"""The port's train step (modelcompression_tpu_torch/train/train_step.py)
against the JAX package's, BITMATCH (fp32), augment off, on the same numpy
params and batch: one and two steps, comparing the loss and metrics, the
gradients, the updated params, the momentum buffers and the BN running
stats; again with subdivisions=2, freeze_prefix=1 (the frozen conv
bit-identical), weight masks (pruned weights exactly zero after every
step), EMA and bn_l1. Also the batch-statistics forward, the six LR
policies with burn-in, and the step's own errors.

Tolerances (fp32 on the CPU; the two packages' convolutions sum in other
orders, about 1e-6 relative per conv, and six convs with batch-stat BN
carry that to about 1e-5 at the loss): metrics 1e-4 relative; gradients,
momentum buffers and running stats 1e-4 of the tensor's largest
magnitude; params 1e-4 of the update's largest magnitude + 1e-6 of the
param's; EMA 1e-4 of its largest magnitude. The JAX
step does not return gradients: they are read from its first momentum
buffer, trace_1 = g + decay * w_0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.compress import (
    magnitude_masks_perlayer as jax_masks,
)
from modelcompression_tpu.core.precision import BITMATCH as JAX_BITMATCH
from modelcompression_tpu.data.fixtures import tiny_region_cfg
from modelcompression_tpu.models import forward as jax_forward
from modelcompression_tpu.models import init_params as jax_init
from modelcompression_tpu.models import parse_cfg as jax_parse
from modelcompression_tpu.train import train_step as jts
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.models import (
    forward, init_params, params_from_jax, params_to_jax, parse_cfg,
)
from modelcompression_tpu_torch.train import train_step as tts

SIZE, BATCH = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (b, SIZE, SIZE, 3), dtype=np.uint8)
    targets = np.zeros((b, 8, 5), np.float32)
    for i in range(b):
        targets[i, 0] = [rng.integers(0, 3), 0.5, 0.5, 0.4, 0.4]
        targets[i, 1] = [rng.integers(0, 3), 0.2, 0.25, 0.2, 0.3]
    return images, targets


def _setup(seed=0, **kw):
    text = tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE)
    jspec, tspec = jax_parse(text), parse_cfg(text)
    np_params = jax.tree.map(np.array, jax_init(jspec, jax.random.key(seed)))
    base = dict(augment_flip=False, augment_jitter=0.0)
    base.update(kw)
    jcfg = jts.TrainConfig.from_spec(jspec, precision=JAX_BITMATCH, **base)
    tcfg = tts.TrainConfig.from_spec(tspec, precision=BITMATCH, **base)
    return jspec, tspec, np_params, jcfg, tcfg


def _trace(opt_state):
    """The optax momentum (TraceState.trace) inside the chained state."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, tuple):
        for s in opt_state:
            t = _trace(s)
            if t is not None:
                return t
    return None


def _run_jax(jspec, jcfg, np_params, n_steps, masks=None, ema=False,
             seed=0):
    tx = jts.make_optimizer(jcfg)
    state = jts.TrainState.create(
        jax.tree.map(jnp.asarray, np_params), tx, jax.random.key(1),
        weight_masks=masks, ema=ema)
    step = jts.make_train_step(jspec, jcfg, tx)
    images, targets = _batch(seed=seed)
    out = []
    for _ in range(n_steps):
        state, m = step(state, jnp.asarray(images), jnp.asarray(targets))
        trace = _trace(state["opt_state"])
        out.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "params": jax.tree.map(np.array, state["params"]),
            "trace": jax.tree.map(np.array, trace),
            "ema": (jax.tree.map(np.array, state["ema_params"])
                    if ema else None)})
    return out


def _oihw(a):
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _run_torch(tspec, tcfg, np_params, n_steps, masks=None, ema=False,
               seed=0):
    params = params_from_jax(np_params, tspec)
    state = tts.TrainState.create(
        params, tts.make_optimizer(tcfg), torch.Generator().manual_seed(1),
        weight_masks=masks, ema=ema)
    step = tts.make_train_step(tspec, tcfg)
    images, targets = _batch(seed=seed)
    opt = state["optimizer"]
    out = []
    for _ in range(n_steps):
        state, m = step(state, images, targets)
        p = state["params"]
        out.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "params": _copied(params_to_jax(p)),
            "grads": {k: {n: _np(v.grad) for n, v in q.items()
                          if v.grad is not None} for k, q in p.items()},
            "bufs": {k: {n: _np(opt.state[v]["momentum_buffer"])
                         for n, v in q.items() if v in opt.state}
                     for k, q in p.items()},
            "ema": (_copied(params_to_jax(state["ema_params"])) if ema
                    else None)})
    return out, state


def _copied(tree):
    """params_to_jax shares memory with CPU fp32 tensors, which the next
    step updates in place."""
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items()}


def _np(t):
    a = t.detach().numpy().copy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a  # OIHW -> HWIO


def _close_scaled(got, want, frac, what):
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: max err {err}, scale {scale}"


def _compare(got, want, decay, w_prev, check_grads=True):
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    for k, p in want["params"].items():
        for n, a in p.items():
            g = got["params"][k][n]
            if n in ("mean", "var"):
                _close_scaled(g, a, 1e-4, f"running {k}/{n}")
            else:
                # the update within the gradients' tolerance, plus float
                # rounding of the param itself
                tol = 1e-4 * np.abs(a - w_prev[k][n]).max() \
                    + 1e-6 * np.abs(a).max()
                err = np.abs(g - a).max()
                assert err <= tol, f"param {k}/{n}: max err {err} > {tol}"
                _close_scaled(got["bufs"][k][n], want["trace"][k][n], 1e-4,
                              f"momentum {k}/{n}")
                if check_grads:
                    g_jax = want["trace"][k][n] - decay * w_prev[k][n]
                    _close_scaled(got["grads"][k][n], g_jax, 1e-4,
                                  f"grad {k}/{n}")


def _check_steps(tcfg, jres, tres, np_params):
    _compare(tres[0], jres[0], tcfg.decay, np_params)
    _compare(tres[1], jres[1], tcfg.decay, jres[0]["params"],
             check_grads=False)


@pytest.mark.parametrize("case", ["plain", "subdivisions2", "bn_l1"])
def test_steps_match_jax(case):
    kw = {"plain": {}, "subdivisions2": {"subdivisions": 2},
          "bn_l1": {"bn_l1": 1e-3}}[case]
    jspec, tspec, np_params, jcfg, tcfg = _setup(seed=1, **kw)
    jres = _run_jax(jspec, jcfg, np_params, 2)
    tres, state = _run_torch(tspec, tcfg, np_params, 2)
    _check_steps(tcfg, jres, tres, np_params)
    assert state["step"] == 2 and state["seen"] == 2 * BATCH
    if case == "bn_l1":
        assert tres[0]["metrics"]["gamma_l1"] > 0


def _grid_qat_setup(seed, int8_layers):
    """A BN-free net (the JAX package's QAT fixture) whose QAT forward is
    exact on both sides: weights on per-channel grids of 2^-9 with each
    channel's largest |w| exactly 127 steps, biases on their conv's
    output grid, and every activation grid a power of two (the
    calibrated absmax rounded up to 127 · 2^k). Every fake-quant then
    lands on its grid with no rounding, and every conv sum is exact, so
    no rounding tie can fall differently in the two packages' forwards
    (with BN, or off these grids, the reference's own QAT step moves by
    a fraction of its gradients under a 2-ulp change of one weight)."""
    from modelcompression_tpu.compress import qat as jqat
    from modelcompression_tpu.compress import quantize as jq
    from modelcompression_tpu_torch.compress import qat as tqat
    from tests.test_qat import NO_BN_CFG
    # the head sized for its 2 anchors x (5 + 3 classes), so it trains
    text = NO_BN_CFG.replace("filters=40", "filters=16")
    jspec, tspec = jax_parse(text), parse_cfg(text)
    rng = np.random.default_rng(seed)
    np_params, step = {}, 2.0 ** -9
    for i in jspec.conv_indices():
        l = jspec.layers[i]
        w = rng.integers(-127, 128, (l.size, l.size, l.in_channels,
                                     l.filters)).astype(np.float32)
        w[0, 0, 0, :] = rng.choice([-127.0, 127.0], l.filters)
        np_params[f"conv{i}"] = {"w": w * np.float32(step),
                                 "bias": np.zeros(l.filters, np.float32)}
    calib = [_batch(seed=seed)[0].astype(np.float32) / 255.0]
    absmax, _ = jq.collect_act_absmax(
        jax.tree.map(jnp.asarray, np_params), jspec, calib)
    p2 = 127.0 * 2.0 ** np.ceil(np.log2(np.maximum(absmax, 1e-3) / 127.0))
    in_max = 127.0 * 2.0 ** -7
    jplan = jqat.qat_spec_from_absmax(jspec, p2, in_max,
                                      int8_layers=int8_layers)
    out_s, in_s = jq._layer_out_scales(jspec, p2, in_max)
    for i in jspec.conv_indices():  # biases on the conv's output grid
        grid = in_s if i == 0 else out_s[i - 1]
        np_params[f"conv{i}"]["bias"] = (rng.integers(
            -64, 65, jspec.layers[i].filters) * grid * step
        ).astype(np.float32)
    return jspec, tspec, np_params, jplan, tqat.QATSpec(**vars(jplan))


@pytest.mark.parametrize("case", ["all", "subset_masks_remat"])
def test_qat_step_matches_jax(case):
    """One QAT step (fake-quant of the selected convs' inputs, weights
    and outputs) against the JAX package's, held as the plain step is:
    metrics, gradients, momentum and params. With a conv subset, weight
    masks (each channel's largest weight kept, so its grid stays) and
    remat too. The QAT forward engages: the plain step's loss differs."""
    remat = case != "all"
    sel = [0, 4] if remat else None
    jspec, tspec, np_params, jplan, tplan = _grid_qat_setup(8, sel)
    base = dict(augment_flip=False, augment_jitter=0.0, remat=remat)
    jcfg = jts.TrainConfig.from_spec(jspec, precision=JAX_BITMATCH,
                                     qat=jplan, **base)
    tcfg = tts.TrainConfig.from_spec(tspec, precision=BITMATCH, qat=tplan,
                                     **base)
    jm = tmasks = None
    if remat:
        rng = np.random.default_rng(9)
        jm = {}
        for k, p in np_params.items():
            m = rng.uniform(size=p["w"].shape) > 0.5
            m[0, 0, 0, :] = True
            jm[k] = m
        tmasks = {k: torch.from_numpy(np.ascontiguousarray(_oihw(m)))
                  for k, m in jm.items()}
        jm = {k: jnp.asarray(m) for k, m in jm.items()}
    jres = _run_jax(jspec, jcfg, np_params, 1, masks=jm)
    tres, _ = _run_torch(tspec, tcfg, np_params, 1, masks=tmasks)
    _compare(tres[0], jres[0], tcfg.decay, np_params)
    plain = tts.TrainConfig.from_spec(tspec, precision=BITMATCH, **base)
    p_res, _ = _run_torch(tspec, plain, np_params, 1, masks=tmasks)
    assert p_res[0]["metrics"]["loss"] != tres[0]["metrics"]["loss"]


def test_qat_step_with_bn_matches_jax():
    """The path ``finetune --qat`` trains: batch-stat BN and calibrated
    grids that are not powers of two (the JAX package's
    ``qat_spec_from_batches`` plan, given to both). The calibration batch
    holds a 255 pixel, as real images do, so the input grid is 1/127 and
    no input k/255 sits on a rounding tie (on the grid 2/255 every odd k
    does, and the jitted reference rounds its division by the constant
    scale otherwise than eager JAX and the port: 1 of the 256 codes).
    Held:

    * the first conv, from both packages' own functions on the same
      images: the input and the per-channel weight fake-quants bit-equal;
      the conv's batch statistics on them as the plain step holds them
      (1e-4 of their largest); the post-BN-activation output fake-quant at
      most one code step apart on at most 1e-4 of its codes (the two
      packages sum the conv in other orders, ~1e-6 relative, and a sum
      that close to a rounding tie falls either way);
    * in one QAT step, the running statistics of the first three convs at
      1e-4 of their largest, as the plain step holds them (they moved at
      most 3.0e-5 on seeds 1 to 4; without the step's weight fake-quant,
      2.4e-3 and more), and the loss within 5e-3 relative: each flipped
      code moves one activation by a grid step (1/127 of its range) and
      every later fake-quant can flip again from there, so the later
      convs' statistics drift (up to 1.7e-3 by the fifth) and the loss
      moved 0.07% to 0.24% on seeds 1 to 4; 5e-3 is twice the largest;
    * the QAT forward engages: the plain step's loss differs.

    Not held here: the BN case's gradients and updated weights, which
    flipped codes move by a share of the update itself (the grid case
    above holds them at the plain step's tolerances)."""
    from modelcompression_tpu.compress import qat as jqat
    from modelcompression_tpu_torch.compress import qat as tqat
    jspec, tspec, np_params, _, _ = _setup(seed=1)
    calib = _batch(seed=11)[0]
    calib[0, 0, 0, 0] = 255
    jplan = jqat.qat_spec_from_batches(
        jax.tree.map(jnp.asarray, np_params), jspec,
        [calib.astype(np.float32) / 255.0])
    tplan = tqat.QATSpec(**vars(jplan))
    grids = [*jplan.in_scale.values(), *jplan.out_scale.values()]
    assert all(np.log2(g) % 1 for g in grids)

    x = _batch()[0].astype(np.float32) / 255.0
    p = jax.tree.map(jnp.asarray, np_params["conv0"])
    jxq = jqat.fake_quant(jnp.asarray(x), jplan.in_scale[0])
    jwq = jqat.fake_quant_weight(p["w"])
    jy, jstats = jts._conv_block_train(jxq, dict(p, w=jwq), jspec.layers[0],
                                       JAX_BITMATCH)
    jyq = np.array(jqat.fake_quant(jy, jplan.out_scale[0]))
    tp = params_from_jax(np_params, tspec)["conv0"]
    txq = tqat.fake_quant(torch.from_numpy(x).permute(0, 3, 1, 2),
                          tplan.in_scale[0])
    twq = tqat.fake_quant_weight(tp["w"])
    ty, tstats = tts._conv_block_train(
        txq.contiguous(memory_format=torch.channels_last), dict(tp, w=twq),
        tspec.layers[0], BITMATCH)
    tyq = tqat.fake_quant(ty, tplan.out_scale[0]).detach()
    assert np.array_equal(txq.permute(0, 2, 3, 1).numpy(), np.array(jxq))
    assert np.array_equal(_np(twq), np.array(jwq))
    for n in ("mean", "var"):
        _close_scaled(tstats[n].detach().numpy(), np.array(jstats[n]), 1e-4,
                      f"batch {n}")
    steps = np.abs(np.round(tyq.permute(0, 2, 3, 1).numpy()
                            / tplan.out_scale[0])
                   - np.round(jyq / jplan.out_scale[0]))
    assert steps.max() <= 1 and (steps > 0).mean() <= 1e-4

    base = dict(augment_flip=False, augment_jitter=0.0)
    jcfg = jts.TrainConfig.from_spec(jspec, precision=JAX_BITMATCH,
                                     qat=jplan, **base)
    tcfg = tts.TrainConfig.from_spec(tspec, precision=BITMATCH, qat=tplan,
                                     **base)
    jres = _run_jax(jspec, jcfg, np_params, 1)
    tres, _ = _run_torch(tspec, tcfg, np_params, 1)
    for k in [f"conv{i}" for i in tspec.conv_indices()[:3]]:
        for n in ("mean", "var"):
            _close_scaled(tres[0]["params"][k][n], jres[0]["params"][k][n],
                          1e-4, f"running {k}/{n}")
    assert tres[0]["metrics"]["loss"] == pytest.approx(
        jres[0]["metrics"]["loss"], rel=5e-3)
    plain = tts.TrainConfig.from_spec(tspec, precision=BITMATCH, **base)
    p_res, _ = _run_torch(tspec, plain, np_params, 1)
    assert p_res[0]["metrics"]["loss"] != tres[0]["metrics"]["loss"]


def test_freeze_prefix_bit_identical_and_matches_jax():
    jspec, tspec, np_params, jcfg, tcfg = _setup(seed=2, freeze_prefix=1)
    jres = _run_jax(jspec, jcfg, np_params, 2)
    tres, state = _run_torch(tspec, tcfg, np_params, 2)
    _check_steps(tcfg, jres, tres, np_params)
    k0 = f"conv{tspec.conv_indices()[0]}"
    init = params_from_jax(np_params)[k0]
    for n, v in state["params"][k0].items():
        assert torch.equal(v.detach(), init[n]), n
    # no gradient reached the frozen conv
    assert all(not g.any() for g in tres[0]["grads"][k0].values())


def test_weight_masks_keep_zeros_and_match_jax():
    jspec, tspec, np_params, jcfg, tcfg = _setup(seed=3)
    jm = jax_masks(jax.tree.map(jnp.asarray, np_params), jspec, 0.5)
    masks_np = {k: np.asarray(m) for k, m in jm.items()}
    tmasks = {k: torch.from_numpy(np.ascontiguousarray(_oihw(m)))
              for k, m in masks_np.items()}
    jres = _run_jax(jspec, jcfg, np_params, 2, masks=jm)
    tres, state = _run_torch(tspec, tcfg, np_params, 2, masks=tmasks)
    _check_steps(tcfg, jres, tres, np_params)
    for r in tres:
        for k, m in masks_np.items():
            w = r["params"][k]["w"]
            assert (w[~m] == 0).all(), k
            assert (r["grads"][k]["w"][~m] == 0).all(), k
    k = next(iter(masks_np))
    assert not np.allclose(tres[-1]["params"][k]["w"][masks_np[k]],
                           np_params[k]["w"][masks_np[k]])


def test_ema_matches_jax():
    jspec, tspec, np_params, jcfg, tcfg = _setup(seed=4, ema_decay=0.9)
    jres = _run_jax(jspec, jcfg, np_params, 2, ema=True)
    tres, _ = _run_torch(tspec, tcfg, np_params, 2, ema=True)
    _check_steps(tcfg, jres, tres, np_params)
    for k, p in jres[-1]["ema"].items():
        for n, a in p.items():
            _close_scaled(tres[-1]["ema"][k][n], a, 1e-4, f"ema {k}/{n}")
    # a config with decay but a state without the buffer is rejected
    with pytest.raises(ValueError, match="ema=True"):
        _run_torch(tspec, tcfg, np_params, 1, ema=False)


def test_batch_stat_forward_matches_jax():
    text = tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE)
    jspec, tspec = jax_parse(text), parse_cfg(text)
    np_params = jax.tree.map(np.array, jax_init(jspec, jax.random.key(5)))
    images, _ = _batch(seed=5)
    x = images.astype(np.float32) / 255.0
    for train_stats in (True, False):
        want = np.asarray(jax_forward(jax.tree.map(jnp.asarray, np_params),
                                      jnp.asarray(x), jspec, JAX_BITMATCH,
                                      train_stats=train_stats))
        got = forward(params_from_jax(np_params), torch.from_numpy(x),
                      tspec, BITMATCH, train_stats=train_stats).numpy()
        _close_scaled(got, want, 1e-5, f"raw map train_stats={train_stats}")
    # batch statistics differ from the running ones (init mean 0, var 1)
    assert not np.allclose(
        forward(params_from_jax(np_params), torch.from_numpy(x), tspec,
                BITMATCH, train_stats=True).numpy(), want, atol=1e-3)


LR_CASES = {
    "steps": dict(policy="steps", burn_in=10, steps=(-1, 20, 40),
                  scales=(0.5, 0.1, 10.0)),
    "step": dict(policy="step", step=7, scales=(0.5,)),
    "poly": dict(policy="poly", max_batches=50, power=4.0, burn_in=5),
    "exp": dict(policy="exp", gamma=0.97),
    "sig": dict(policy="sig", gamma=0.2, step=30),
    "constant": dict(policy="constant", burn_in=8),
}


@pytest.mark.parametrize("policy", sorted(LR_CASES))
def test_lr_schedule_matches_jax(policy):
    kw = dict(learning_rate=0.01, **LR_CASES[policy])
    want = jts.darknet_lr_schedule(jts.TrainConfig(**kw))
    got = tts.darknet_lr_schedule(tts.TrainConfig(**kw))
    for s in range(0, 61):
        assert got(s) == pytest.approx(float(want(s)), rel=1e-6, abs=1e-12), s
    with pytest.raises(ValueError):
        tts.darknet_lr_schedule(tts.TrainConfig(policy="cosine"))


def test_not_ported_options_name_their_item():
    """Named when gmp and distill were rejected naming ROADMAP Queue 1 item
    6; both are ported now (tests/test_torch_gmp.py and
    test_torch_distill.py compare their steps with the JAX package's).
    What stays: the JAX step's own errors, a GMP config over a state
    without its masks and a freeze that leaves nothing to train."""
    from modelcompression_tpu_torch.compress import GMPSpec
    from modelcompression_tpu_torch.train import make_distill_plan
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE))
    config = tts.TrainConfig(gmp=GMPSpec(final_sparsity=0.5, end=2,
                                         frequency=1),
                             augment_flip=False)
    params = init_params(spec, seed=0)
    state = tts.TrainState.create(params, tts.make_optimizer(config),
                                  torch.Generator().manual_seed(0))
    images, targets = _batch()
    with pytest.raises(ValueError, match="gmp_init_masks"):
        tts.make_train_step(spec, config)(state, images, targets)
    plan = make_distill_plan(params, spec, spec)
    assert callable(tts.make_train_step(spec, tts.TrainConfig(),
                                        distill=plan))
    with pytest.raises(ValueError, match="freeze_prefix"):
        tts.make_train_step(spec, tts.TrainConfig(freeze_prefix=99))


def test_uint8_flip_fast_path_equals_float_chain():
    """With flip on and no jitter/mosaic the step flips the uint8 batch
    before normalizing; the result equals the float chain on the same
    draws (a permutation and a select)."""
    _, tspec, np_params, _, tcfg = _setup(seed=6, augment_flip=True)
    images, targets = _batch(seed=6)
    out = []
    for imgs in (images, images.astype(np.float32) / 255.0):
        state = tts.TrainState.create(
            params_from_jax(np_params, tspec), tts.make_optimizer(tcfg),
            torch.Generator().manual_seed(9))
        _, m = tts.make_train_step(tspec, tcfg)(state, imgs, targets)
        out.append((m["loss"].item(), params_to_jax(state["params"])))
    assert out[0][0] == out[1][0]
    for k, p in out[0][1].items():
        for n, a in p.items():
            assert np.array_equal(a, out[1][1][k][n]), (k, n)


def test_augment_chain_draws_are_reproducible():
    _, tspec, np_params, _, tcfg = _setup(
        seed=7, augment_flip=True, augment_jitter=0.3, augment_mosaic=True,
        augment_hsv=True)
    images, targets = _batch(seed=7)
    losses = []
    for _ in range(2):
        state = tts.TrainState.create(
            params_from_jax(np_params, tspec), tts.make_optimizer(tcfg),
            torch.Generator().manual_seed(3))
        step = tts.make_train_step(tspec, tcfg)
        losses.append([step(state, images, targets)[1]["loss"].item()
                       for _ in range(2)])
    assert losses[0] == losses[1] and all(np.isfinite(losses[0]))
    x = torch.from_numpy(images).float() / 255.0
    x2, t2 = tts.augment_batch(dataclasses.replace(tcfg), x,
                               torch.from_numpy(targets),
                               torch.Generator().manual_seed(0))
    assert x2.shape == x.shape and t2.shape == (BATCH, 4 * 8, 5)
