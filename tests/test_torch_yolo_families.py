"""The YOLOv3 / YOLOv4 families in the port against the JAX package: the
bundled cfgs (parse only), the fixture cfg text, the multi-head forward
and BN-folded forward on the v3, v4-tiny and SPP fixtures, the .weights
codec, the CSP-balanced keep-sets and the repack, and the [yolo] decode.

Tolerances: BITMATCH raw maps max |port - jax| / max |jax| <= 1e-5 per
head (fp32 convolutions on the CPU that sum the same terms in different
orders; see tests/test_torch_darknet.py). FAST raw maps within 2 bf16
ulps of each head's largest magnitude: every conv rounds its input and
weights to bf16, so a summation-order difference can move an
intermediate activation by one bf16 ulp. mish is x * tanh(softplus(x));
torch's softplus returns x itself above 20, jax.nn.softplus does not,
which differs by far less than an fp32 ulp of x there. Decode: 1e-6
relative (sigmoid / exp on the same fp32 inputs). Keep-sets and codec
bytes: equal."""

import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.core.precision import BITMATCH as J_BITMATCH
from modelcompression_tpu.core.precision import FAST as J_FAST
from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.evaluation import decode as jdec
from modelcompression_tpu.models import cfg as jcfg
from modelcompression_tpu.models import darknet as jdn
from modelcompression_tpu.models import weights_io as jwio
from modelcompression_tpu.models import zoo as jzoo
from modelcompression_tpu_torch.core.precision import BITMATCH, FAST
from modelcompression_tpu_torch.data import fixtures as tfx
from modelcompression_tpu_torch.evaluation import decode as tdec
from modelcompression_tpu_torch.models import cfg as tcfg
from modelcompression_tpu_torch.models import darknet as tdn
from modelcompression_tpu_torch.models import weights_io as twio
from modelcompression_tpu_torch.models import zoo as tzoo
from modelcompression_tpu_torch.models.convert import (
    params_from_jax, params_to_jax,
)
from tests.test_spp import spp_fixture_cfg
from tests.test_torch_darknet import random_np_params

jrepack = importlib.import_module("modelcompression_tpu.compress.repack")
trepack = importlib.import_module("modelcompression_tpu_torch.compress.repack")
jcrit = importlib.import_module("modelcompression_tpu.compress.criteria")
tcrit = importlib.import_module("modelcompression_tpu_torch.compress.criteria")

REL_TOL = 1e-5
ZOO = ["yolov2_voc", "tiny_yolov2_voc", "yolov2_coco", "tiny_yolov2_coco",
       "yolov3_coco", "yolov3_voc", "yolov3_spp_coco", "yolov3_tiny_coco",
       "yolov3_tiny_voc", "yolov4_coco", "yolov4_voc", "yolov4_tiny_coco",
       "yolov4_tiny_voc"]
FIXTURES = {
    "v3": (lambda: jfx.tiny_yolo3_cfg(num_classes=3), 64),
    "v4_tiny": (lambda: jfx.tiny_yolo4_cfg(num_classes=3), 64),
    "spp": (lambda: spp_fixture_cfg(num_classes=3), 32),
}


def _fixture(kind):
    text_fn, net = FIXTURES[kind]
    text = text_fn()
    return jcfg.parse_cfg(text), tcfg.parse_cfg(text), net


def _x(b, net, seed=1):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, net, net, 3)).astype(np.float32)


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- the zoo and the fixture cfgs --------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_zoo_cfg_parses_as_jax(name):
    j, t = getattr(jzoo, name)(), getattr(tzoo, name)()
    assert tcfg.dump_cfg(t) == jcfg.dump_cfg(j)
    assert t.head_indices() == j.head_indices()
    assert t.classes == j.classes and t.is_multi_head == j.is_multi_head
    assert (t.net.width, t.net.height) == (j.net.width, j.net.height)
    assert tdn.num_conv_flops(t) == jdn.num_conv_flops(j)
    assert [getattr(l, "in_channels", None) for l in t.layers] == \
        [getattr(l, "in_channels", None) for l in j.layers]


def test_names_paths():
    for fn, n in (("coco_names_path", 80), ("voc_names_path", 20)):
        path = getattr(tzoo, fn)()
        with open(path) as f:
            t = f.read()
        with open(getattr(jzoo, fn)()) as f:
            assert t == f.read()
        assert len(t.split()) >= n


@pytest.mark.parametrize("fn, kw", [
    ("tiny_yolo3_cfg", {}),
    ("tiny_yolo3_cfg", {"num_classes": 20, "width": 96, "height": 128}),
    ("tiny_yolo4_cfg", {}),
    ("tiny_yolo4_cfg", {"iou_loss": "ciou", "iou_normalizer": 0.5,
                        "chmul": 2, "num_classes": 5}),
])
def test_fixture_cfg_text_equal(fn, kw):
    assert getattr(tfx, fn)(**kw) == getattr(jfx, fn)(**kw)


# ---- forward and folded forward ----------------------------------------

def _heads(y):
    assert isinstance(y, (tuple, list))
    return [np.asarray(h.float() if torch.is_tensor(h) else h, np.float32)
            for h in y]


@pytest.mark.parametrize("kind", sorted(FIXTURES))
@pytest.mark.parametrize("folded", [False, True])
def test_forward_bitmatch_matches_jax(kind, folded):
    jspec, tspec, net = _fixture(kind)
    npp = random_np_params(jspec, seed=7)
    x = _x(2, net)
    jp, tp = jax.tree.map(jnp.asarray, npp), params_from_jax(npp, tspec)
    if folded:
        want = jdn.forward_folded(jdn.fold_batchnorm(jp, jspec),
                                  jnp.asarray(x), jspec, J_BITMATCH)
        got = tdn.forward_folded(tdn.fold_batchnorm(tp, tspec),
                                 torch.from_numpy(x), tspec, BITMATCH)
    else:
        want = jdn.forward(jp, jnp.asarray(x), jspec, J_BITMATCH)
        got = tdn.forward(tp, torch.from_numpy(x), tspec, BITMATCH)
    want, got = _heads(want), _heads(got)
    assert len(got) == len(want) == len(jspec.head_indices())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= REL_TOL


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_forward_fast_within_two_bf16_ulps(kind):
    jspec, tspec, net = _fixture(kind)
    npp = random_np_params(jspec, seed=8)
    x = _x(2, net, seed=2)
    jf = jdn.fold_batchnorm(jax.tree.map(jnp.asarray, npp), jspec)
    tf = tdn.fold_batchnorm(params_from_jax(npp, tspec), tspec)
    want = _heads(jdn.forward_folded(jf, jnp.asarray(x), jspec, J_FAST))
    got = _heads(tdn.forward_folded(tf, torch.from_numpy(x), tspec, FAST))
    for g, w in zip(got, want):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(g - w).max() <= 2 * ulp


def test_head_order_and_layer_kinds():
    """v3: [shortcut] + [upsample] + route concat; v4-tiny: the grouped
    [route] and mish; SPP: three stride-1 maxpools (5/9/13) in a 4-way
    concat. Heads come out in network order, strides as the cfg says."""
    for kind, strides in (("v3", (8, 4)), ("v4_tiny", (4, 2)),
                          ("spp", (2,))):
        jspec, tspec, net = _fixture(kind)
        kinds = {type(l).__name__ for l in tspec.layers}
        if kind == "v3":
            assert {"ShortcutLayer", "UpsampleLayer"} <= kinds
        if kind == "v4_tiny":
            assert any(getattr(l, "groups", 1) == 2 for l in tspec.layers)
            assert any(getattr(l, "activation", "") == "mish"
                       for l in tspec.layers)
        if kind == "spp":
            assert sorted(l.size for l in tspec.layers
                          if type(l).__name__ == "MaxPoolLayer"
                          and l.stride == 1) == [5, 9, 13]
        params = tdn.init_params(tspec, seed=1)
        y = tdn.forward(params, torch.zeros(1, net, net, 3), tspec,
                        BITMATCH)
        assert [h.shape[1] for h in y] == [net // s for s in strides]


# ---- the .weights codec ------------------------------------------------

@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_weights_written_by_jax_load_equal_and_round_trip(kind, tmp_path):
    jspec, tspec, _ = _fixture(kind)
    npp = random_np_params(jspec, seed=9)
    path = str(tmp_path / "net.weights")
    jwio.save_weights(path, jspec, npp, seen=5)
    params, seen = twio.load_weights(path, tspec)
    assert seen == 5
    want = params_from_jax(npp)
    assert params.keys() == want.keys()
    for k in want:
        for n in want[k]:
            assert torch.equal(params[k][n], want[k][n])
    with open(path, "rb") as f:
        assert twio.roundtrip_bytes(tspec, params, seen=5) == f.read()
    blob = twio.roundtrip_bytes(tspec, params, seen=6)
    back, _ = jwio.load_weights(io.BytesIO(blob), jspec)
    for k in npp:
        for n in npp[k]:
            np.testing.assert_array_equal(back[k][n], npp[k][n])


# ---- keep-sets and repack ----------------------------------------------

def _keep_sets(jspec, tspec, npp, fraction):
    jkeep = jrepack.uniform_filter_fraction_keep_sets(
        jspec, jax.tree.map(jnp.asarray, npp), fraction)
    tkeep = trepack.uniform_filter_fraction_keep_sets(
        tspec, params_from_jax(npp), fraction)
    assert jkeep.keys() == tkeep.keys()
    for i in jkeep:
        np.testing.assert_array_equal(tkeep[i], np.asarray(jkeep[i]))
    return jkeep, tkeep


@pytest.mark.parametrize("kind", sorted(FIXTURES))
@pytest.mark.parametrize("fraction", [0.5, 0.75])
def test_keep_sets_repack_and_slimmed_equal_masked(kind, fraction):
    jspec, tspec, net = _fixture(kind)
    npp = random_np_params(jspec, seed=10)
    jkeep, tkeep = _keep_sets(jspec, tspec, npp, fraction)
    js, jp = jrepack.repack(jspec, npp, jkeep)
    ts, tp = trepack.repack(tspec, params_from_jax(npp), tkeep)
    assert tcfg.dump_cfg(ts) == jcfg.dump_cfg(js)
    jp = jax.tree.map(np.asarray, jp)
    got = params_to_jax(tp)
    for k in jp:
        for n in jp[k]:
            np.testing.assert_array_equal(got[k][n], jp[k][n])
    # the slimmed forward equals the masked forward (port alone)
    x = torch.from_numpy(_x(2, net, seed=3))
    masks = trepack.channel_masks_from_keep(tspec, tkeep)
    masked = tdn.forward(params_from_jax(npp), x, tspec, BITMATCH,
                         channel_masks=masks)
    slim = tdn.forward(tp, x, ts, BITMATCH)
    for a, b in zip(slim, masked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_v4_tiny_csp_source_is_pruned_balanced():
    jspec, tspec, _ = _fixture("v4_tiny")
    npp = random_np_params(jspec, seed=2)
    _, tkeep = _keep_sets(jspec, tspec, npp, 0.5)
    k1 = np.asarray(tkeep[1])
    assert len(k1) == 20 and (k1 < 20).sum() == (k1 >= 20).sum() == 10
    assert tcrit.csp_balanced_keep_sets(params_from_jax(npp), tspec, 0.5) \
        .keys() == {1}


def test_yolov4_coco_keep_sets_match_jax():
    """The full YOLOv4 graph (SPP, PAN, route-back CSP stages): keep-sets
    only, no forward."""
    jspec, tspec = jzoo.yolov4_coco(), tzoo.yolov4_coco()
    rng = np.random.default_rng(0)
    npp = {}
    for i, l in enumerate(jspec.layers):
        if isinstance(l, jcfg.ConvLayer):
            npp[f"conv{i}"] = {"w": rng.standard_normal(
                (1, 1, l.in_channels, l.filters)).astype(np.float32)
                * np.ones((l.size, l.size, 1, 1), np.float32)}
    tp = params_from_jax(npp)
    jkeep = jrepack.uniform_filter_fraction_keep_sets(jspec, npp, 0.5)
    tkeep = trepack.uniform_filter_fraction_keep_sets(tspec, tp, 0.5)
    assert jkeep.keys() == tkeep.keys() and len(tkeep) > 40
    for i in jkeep:
        np.testing.assert_array_equal(tkeep[i], np.asarray(jkeep[i]))
    ts, _ = trepack.repack(tspec, tp, tkeep)
    js, _ = jrepack.repack(jspec, npp, jkeep)
    assert tdn.num_conv_flops(ts) == jdn.num_conv_flops(js)


# ---- decode --------------------------------------------------------------

@pytest.mark.parametrize("scale_x_y", [1.0, 1.05, 1.2])
def test_decode_yolo_matches_jax(scale_x_y):
    jspec, tspec, _ = _fixture("v4_tiny")
    hi = jspec.head_indices()[0]
    jl, tl = jspec.layers[hi], tspec.layers[hi]
    jl.scale_x_y = tl.scale_x_y = scale_x_y
    raw = np.random.default_rng(4).normal(
        0, 2, (2, 5, 7, jl.n * (5 + jl.classes))).astype(np.float32)
    want = jdec.decode_yolo(jnp.asarray(raw), jl, 64, 96)
    got = tdec.decode_yolo(torch.from_numpy(raw), tl, 64, 96)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["v3", "v4_tiny"])
def test_decode_heads_matches_jax_in_network_order(kind):
    jspec, tspec, net = _fixture(kind)
    npp = random_np_params(jspec, seed=12)
    x = _x(2, net, seed=5)
    raws = tdn.forward(params_from_jax(npp, tspec), torch.from_numpy(x),
                       tspec, BITMATCH)
    want = jdec.decode_heads(tuple(jnp.asarray(r.numpy()) for r in raws),
                             jspec)
    got = tdec.decode_heads(raws, tspec)
    n = sum(r.shape[1] * r.shape[2] * tspec.layers[h].n
            for r, h in zip(raws, tspec.head_indices()))
    assert got[0].shape == (2, n, 4) and got[2].shape == (2, n, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    first = tdec.decode_yolo(raws[0], tspec.layers[tspec.head_indices()[0]],
                             net, net)
    np.testing.assert_array_equal(got[1][:, :first[1].shape[1]].numpy(),
                                  first[1].numpy())
    with pytest.raises(ValueError, match="multi-head"):
        tdec.decode_heads(raws[:1], tspec)
    with pytest.raises(ValueError, match="multi-head"):
        tdec.decode_heads(raws[0], tspec)
