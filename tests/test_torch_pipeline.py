"""The port's serving step, L1 keep-sets and repack against the JAX
package, on a narrow region cfg.

``make_eval_step`` runs with ``fuse_input_stage=True`` on both sides (the
JAX side's fusion goes through its XLA twin on the CPU), fp32 BITMATCH,
with and without on-device letterbox, unpruned and 75%-filter-repacked.
Tolerances: ``n_cand``/``n_any`` and ``valid`` exactly equal; scores
atol 1e-5 (probabilities from fp32 raw maps that differ only in summation
order, ~1e-6 relative); boxes atol 1e-3 source pixels (the same
differences through exp and the letterbox inverse on ~100 px images)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.core.precision import BITMATCH as J_BITMATCH
from modelcompression_tpu.data.fixtures import tiny_region_cfg
from modelcompression_tpu.evaluation import pipeline as jpipe
from modelcompression_tpu.models import cfg as jcfg
from modelcompression_tpu.models import darknet as jdn
from modelcompression_tpu_torch.compress import criteria as tcrit
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.evaluation import pipeline as tpipe
from modelcompression_tpu_torch.models import cfg as tcfg
from modelcompression_tpu_torch.models import darknet as tdn
from modelcompression_tpu_torch.models.convert import (
    params_from_jax, params_to_jax,
)
from tests.test_torch_darknet import random_np_params

# the compress packages export a function named ``repack``, which shadows
# the submodule of the same name as a package attribute
jrepack = importlib.import_module("modelcompression_tpu.compress.repack")
trepack = importlib.import_module("modelcompression_tpu_torch.compress.repack")

NET = 64


def _specs():
    text = tiny_region_cfg(num_classes=3, width=NET, height=NET)
    return jcfg.parse_cfg(text), tcfg.parse_cfg(text)


def _pruned(jspec, tspec, npp, fraction):
    jkeep = jrepack.uniform_filter_fraction_keep_sets(
        jspec, jax.tree.map(jnp.asarray, npp), fraction)
    tkeep = trepack.uniform_filter_fraction_keep_sets(
        tspec, params_from_jax(npp), fraction)
    assert jkeep.keys() == tkeep.keys()
    for i in jkeep:
        np.testing.assert_array_equal(tkeep[i], jkeep[i])
    js, jp = jrepack.repack(jspec, npp, jkeep)
    ts, tp = trepack.repack(tspec, params_from_jax(npp), tkeep)
    return js, jax.tree.map(np.asarray, jp), ts, tp


def _cfgs(**kw):
    base = dict(conf_thresh=0.05, max_detections=16, nms_prefilter=0,
                fuse_input_stage=True)
    base.update(kw)
    return (jpipe.EvalConfig(precision=J_BITMATCH, **base),
            tpipe.EvalConfig(precision=BITMATCH, device="cpu", **base))


def _run_both(jspec, npp, tspec, tparams, src_hw, **kw):
    jc, tc = _cfgs(**kw)
    rng = np.random.default_rng(21)
    shape = src_hw if src_hw is not None else (NET, NET)
    imgs = rng.integers(0, 256, (3, *shape, 3), np.uint8)
    ws = np.array([100.0, 80.0, 64.0], np.float32)
    hs = np.array([75.0, 120.0, 64.0], np.float32)
    jf = jax.tree.map(jnp.asarray, npp)
    tf = tparams
    if tc.fold_bn:
        jf, tf = jdn.fold_batchnorm(jf, jspec), tdn.fold_batchnorm(tf, tspec)
    want = [np.asarray(a) for a in jpipe.make_eval_step(jspec, jc, src_hw)(
        jf, jnp.asarray(imgs), jnp.asarray(ws), jnp.asarray(hs))]
    got = [t.numpy() for t in tpipe.make_eval_step(tspec, tc, src_hw)(
        tf, imgs, ws, hs)]
    return got, want


def _assert_step_equal(got, want):
    (gb, gs, gv, gc, ga), (wb, ws, wv, wc, wa) = got, want
    assert gb.shape == wb.shape and gs.shape == ws.shape
    np.testing.assert_array_equal(gc, wc)   # n_cand
    np.testing.assert_array_equal(ga, wa)   # n_any
    np.testing.assert_array_equal(gv, wv)   # valid
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb, wb, atol=1e-3, rtol=0)
    assert gv.any()  # the comparison saw real detections


@pytest.mark.parametrize("src_hw", [None, (48, 80)])
@pytest.mark.parametrize("prefilter", [0, 128])
def test_eval_step_unpruned_matches_jax(src_hw, prefilter):
    jspec, tspec = _specs()
    npp = random_np_params(jspec, seed=31)
    got, want = _run_both(jspec, npp, tspec, params_from_jax(npp), src_hw,
                          nms_prefilter=prefilter)
    _assert_step_equal(got, want)


@pytest.mark.parametrize("src_hw", [None, (48, 80)])
def test_eval_step_pruned75_matches_jax(src_hw):
    jspec, tspec = _specs()
    npp = random_np_params(jspec, seed=32)
    js, jp, ts, tp = _pruned(jspec, tspec, npp, 0.75)
    assert ts.layers[0].filters == 4
    got, want = _run_both(js, jp, ts, tp, src_hw, nms_prefilter=128)
    _assert_step_equal(got, want)


@pytest.mark.parametrize("kw", [{"letterbox": False}, {"fold_bn": False}])
def test_eval_step_options_match_jax(kw):
    """Stretch resize instead of letterbox; unfolded BN (the fusion is
    then gated off on both sides)."""
    jspec, tspec = _specs()
    npp = random_np_params(jspec, seed=33)
    got, want = _run_both(jspec, npp, tspec, params_from_jax(npp),
                          (48, 80), **kw)
    _assert_step_equal(got, want)


@pytest.mark.parametrize("fraction", [0.5, 0.75])
def test_keep_sets_and_slimmed_params_match_jax(fraction):
    jspec, tspec = _specs()
    npp = random_np_params(jspec, seed=34)
    js, jp, ts, tp = _pruned(jspec, tspec, npp, fraction)
    assert [getattr(l, "filters", None) for l in ts.layers] == \
        [getattr(l, "filters", None) for l in js.layers]
    back = params_to_jax(tp)
    assert back.keys() == jp.keys()
    for k in jp:
        for n in jp[k]:
            np.testing.assert_array_equal(back[k][n], jp[k][n])


def test_keep_sets_match_jax_on_yolov2_voc():
    """The headline model: the same 75% keep-sets and slimmed conv1 width
    from the full-width YOLOv2-VOC params."""
    from modelcompression_tpu.models.zoo import yolov2_voc as j_v2
    from modelcompression_tpu_torch.models.zoo import yolov2_voc as t_v2
    jspec, tspec = j_v2(), t_v2()
    npp = random_np_params(jspec, seed=35)
    jkeep = jrepack.uniform_filter_fraction_keep_sets(
        jspec, jax.tree.map(jnp.asarray, npp), 0.75)
    tparams = params_from_jax(npp)
    tkeep = trepack.uniform_filter_fraction_keep_sets(tspec, tparams, 0.75)
    assert sorted(tkeep) == sorted(jkeep)
    for i in jkeep:
        np.testing.assert_array_equal(tkeep[i], jkeep[i])
    ts, _ = trepack.repack(tspec, tparams, tkeep)
    js, _ = jrepack.repack(jspec, {k: {"w": v["w"]} for k, v in npp.items()},
                           jkeep)
    assert ts.layers[0].filters == js.layers[0].filters == 8
    assert [l.in_channels for l in ts.layers
            if isinstance(l, tcfg.ConvLayer)] == \
        [l.in_channels for l in js.layers if isinstance(l, jcfg.ConvLayer)]


def test_propagate_keep_sets_matches_jax():
    from modelcompression_tpu.models.zoo import yolov2_voc as j_v2
    from modelcompression_tpu_torch.models.zoo import yolov2_voc as t_v2
    jspec, tspec = j_v2(), t_v2()
    rng = np.random.default_rng(36)
    keep = {i: np.sort(rng.choice(l.filters, l.filters // 3, replace=False))
            for i, l in enumerate(tspec.layers)
            if isinstance(l, tcfg.ConvLayer) and i != len(tspec.layers) - 2}
    ji, jo = jrepack.propagate_keep_sets(jspec, keep)
    ti, to = trepack.propagate_keep_sets(tspec, keep)
    for a, b in ((ti, ji), (to, jo)):
        assert a.keys() == b.keys()
        for i in a:
            np.testing.assert_array_equal(a[i], b[i])


def test_slimmed_forward_equals_masked_forward():
    """The repack invariant in the port: slimmed == masked (fp32)."""
    _, tspec = _specs()
    params = tdn.init_params(tspec, seed=3)
    keep = trepack.uniform_filter_fraction_keep_sets(tspec, params, 0.5)
    masks = trepack.channel_masks_from_keep(tspec, keep)
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, NET, NET, 3)).astype(np.float32))
    masked = tdn.forward(params, x, tspec, BITMATCH, channel_masks=masks)
    ss, sp = trepack.repack(tspec, params, keep)
    slim = tdn.forward(sp, x, ss, BITMATCH)
    np.testing.assert_allclose(slim.numpy(), masked.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_l1_scores_and_keep_rule_match_jax():
    from modelcompression_tpu.compress import criteria as jcrit
    w = np.random.default_rng(37).normal(size=(3, 3, 8, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        tcrit.l1_filter_scores(torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))).numpy(),
        np.asarray(jcrit.l1_filter_scores(w)), rtol=1e-6)
    tied = {0: np.array([1.0, 0.5, 0.5, 2.0, 0.5], np.float32)}
    for f in (0.2, 0.4, 0.6):
        np.testing.assert_array_equal(
            tcrit.keep_sets_from_scores(tied, f)[0],
            jcrit.keep_sets_from_scores(tied, f)[0])


@pytest.mark.parametrize("kw", [
    {"soft_nms": "linear"},
    {"soft_nms": "gaussian", "soft_nms_sigma": 0.3},
    {"exact_nms": True},
    {"exact_nms": True, "diou_nms": True, "diou_beta": 0.6},
    {"diou_nms": True},
    {"nms_prefilter_impl": "bisect", "nms_prefilter": 128},
    {"nms_prefilter_impl": "bisect", "nms_prefilter": 20},
    {"exact_nms_prefilter": False, "nms_prefilter": 64, "diou_nms": True},
])
def test_eval_step_nms_variants_match_jax(kw):
    """Every NMS variant of EvalConfig (these options raised
    NotImplementedError before the variants were ported): the serving
    step equals the JAX package's, on device-letterboxed frames. A
    prefilter of 20 overflows (n_any above it) in the bisect case."""
    jspec, tspec = _specs()
    npp = random_np_params(jspec, seed=34)
    got, want = _run_both(jspec, npp, tspec, params_from_jax(npp),
                          (48, 80), **kw)
    _assert_step_equal(got, want)


@pytest.mark.parametrize("kw, match", [
    ({"int8_input": True, "forward_fn": lambda p, x, s: x}, "int8"),
    ({"forward_fn": lambda p, x, s: x}, "forward_fn"),
])
def test_unported_options_raise(kw, match):
    """The int8 path's options, rejected before they were ported: the
    step hands ``forward_fn`` the canvas (int8 on the pytree's input grid
    under ``int8_input``) and its params unfolded, and equals the JAX
    package's step with the same custom forward (here the folded fp32
    forward of the dequantized canvas) on the same frames."""
    int8 = match == "int8"
    jspec, tspec = _specs()
    npp = random_np_params(jspec, seed=35)
    scale = np.float32(1.0 / 127.0)
    jf = jdn.fold_batchnorm(jax.tree.map(jnp.asarray, npp), jspec)
    tf = tdn.fold_batchnorm(params_from_jax(npp), tspec)
    jf["__net__"] = {"input_scale": jnp.asarray(scale)}
    tf["__net__"] = {"input_scale": torch.tensor(scale)}
    seen = []

    def t_fwd(p, x, s):
        seen.append(x.dtype)
        x = x.float() * p["__net__"]["input_scale"] if int8 else x
        return tdn.forward_folded(p, x, s, BITMATCH)

    def j_fwd(p, x, s):
        x = x.astype(jnp.float32) * p["__net__"]["input_scale"] \
            if int8 else x
        return jdn.forward_folded(p, x, s, J_BITMATCH)

    jc = jpipe.EvalConfig(precision=J_BITMATCH, forward_fn=j_fwd,
                          int8_input=int8, conf_thresh=0.05,
                          max_detections=16)
    tc = tpipe.EvalConfig(precision=BITMATCH, device="cpu", forward_fn=t_fwd,
                          int8_input=int8, conf_thresh=0.05,
                          max_detections=16)
    rng = np.random.default_rng(22)
    imgs = rng.integers(0, 256, (3, 48, 80, 3), np.uint8)
    ws = np.array([80.0, 80.0, 64.0], np.float32)
    hs = np.array([48.0, 48.0, 64.0], np.float32)
    want = [np.asarray(a) for a in jpipe.make_eval_step(jspec, jc, (48, 80))(
        jf, jnp.asarray(imgs), jnp.asarray(ws), jnp.asarray(hs))]
    got = [t.numpy() for t in tpipe.make_eval_step(tspec, tc, (48, 80))(
        tf, imgs, ws, hs)]
    assert seen == [torch.int8 if int8 else torch.float32]
    _assert_step_equal(got, want)


def _fwd(p, x, s):
    return x


ACCEPTED = "accepted"


@pytest.mark.parametrize("kw, unported", [
    # invalid for the JAX package: the same exception type from both
    ({"nms_prefilter_impl": "bogus"}, None),
    ({"soft_nms": "bogus"}, None),
    ({"exact_nms": True, "nms_prefilter": 128}, None),
    ({"soft_nms": "linear", "exact_nms": True}, None),
    ({"soft_nms": "gaussian", "diou_nms": True}, None),
    ({"int8_input": True}, None),
    ({"map_iou": 0.0}, None),
    # valid in both packages: the same fields
    ({"exact_nms_prefilter": False}, ACCEPTED),
    ({"soft_nms": "gaussian", "soft_nms_sigma": 0.3}, ACCEPTED),
    ({"exact_nms": True}, ACCEPTED),
    ({"diou_nms": True, "diou_beta": 0.6}, ACCEPTED),
    ({"nms_prefilter_impl": "bisect", "nms_prefilter": 64}, ACCEPTED),
    # the int8 path's custom forward and int8 canvas (ported since)
    ({"forward_fn": _fwd}, ACCEPTED),
    ({"forward_fn": _fwd, "int8_input": True}, ACCEPTED),
])
def test_eval_config_validates_as_jax(kw, unported):
    """Invalid options raise what the JAX package raises (it checks them
    before anything else); valid options both packages take give the same
    fields; valid options the port lacks raise NotImplementedError naming
    their ROADMAP item, and JAX takes them."""
    if unported is None:
        with pytest.raises(Exception) as jexc:
            jpipe.EvalConfig(**kw)
        with pytest.raises(Exception) as texc:
            tpipe.EvalConfig(device="cpu", **kw)
        assert type(texc.value) is type(jexc.value) is ValueError
    elif unported == ACCEPTED:
        j, t = jpipe.EvalConfig(**kw), tpipe.EvalConfig(device="cpu", **kw)
        for name in kw:
            assert getattr(t, name) == getattr(j, name)
    else:
        jpipe.EvalConfig(**kw)
        with pytest.raises(NotImplementedError, match=unported):
            tpipe.EvalConfig(device="cpu", **kw)


def test_eval_config_new_fields_default_as_jax():
    t, j = tpipe.EvalConfig(device="cpu"), jpipe.EvalConfig()
    for name in ("exact_nms_prefilter", "soft_nms_sigma", "diou_beta"):
        assert getattr(t, name) == getattr(j, name)


def test_unported_criteria_raise():
    """Every criterion and tied policy of the JAX package is ported; one
    outside them raises ValueError, as in the JAX package."""
    _, tspec = _specs()
    params = tdn.init_params(tspec)
    with pytest.raises(ValueError, match="unknown filter criterion"):
        trepack.uniform_filter_fraction_keep_sets(tspec, params, 0.5,
                                                  criterion="lamp")
    with pytest.raises(ValueError, match="tied must be"):
        trepack.uniform_filter_fraction_keep_sets(tspec, params, 0.5,
                                                  tied="both")


def test_fuse_input_stage_defaults_on():
    assert tpipe.EvalConfig(device="cpu").fuse_input_stage is True
    assert jpipe.EvalConfig().fuse_input_stage is False


def test_fused_step_runs_the_input_stage(monkeypatch):
    """With the default config the step goes through fused_conv1_pool."""
    from modelcompression_tpu_torch.ops import input_stage as tis
    calls = []
    real = tis.fused_conv1_pool

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(tis, "fused_conv1_pool", spy)
    _, tspec = _specs()
    params = tdn.fold_batchnorm(tdn.init_params(tspec), tspec)
    step = tpipe.make_eval_step(tspec, tpipe.EvalConfig(device="cpu"))
    step(params, np.zeros((2, NET, NET, 3), np.uint8), [64.0, 64.0],
         [64.0, 64.0])
    assert calls == [(2, NET, NET, 3)]


def test_params_on_other_device_raise():
    _, tspec = _specs()
    params = tdn.fold_batchnorm(tdn.init_params(tspec), tspec)
    step = tpipe.make_eval_step(tspec, tpipe.EvalConfig(device="cpu"))
    meta = tdn.params_to(params, "meta")
    with pytest.raises(ValueError, match="params live on meta"):
        step(meta, np.zeros((1, NET, NET, 3), np.uint8), [64.0], [64.0])


def test_src_hw_mismatch_raises():
    _, tspec = _specs()
    params = tdn.fold_batchnorm(tdn.init_params(tspec), tspec)
    step = tpipe.make_eval_step(tspec, tpipe.EvalConfig(device="cpu"),
                                src_hw=(48, 80))
    with pytest.raises(ValueError, match="48, 80"):
        step(params, np.zeros((1, 40, 80, 3), np.uint8), [80.0], [40.0])


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tspec = _specs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.make_eval_step(tspec, tpipe.EvalConfig())
