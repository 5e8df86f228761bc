"""The port's int8 post-training quantization (compress/quantize.py,
ops/int8_conv.py, the int8 maxpool, the int8 canvas, the eval CLI's
--int8 / --qmodel) against the JAX package's, on the CPU, at fixture size
(the region, v3-tiny and v4-tiny fixture nets at 64 px; the eval CLI's
tiny region model at 96 px).

Tolerances:
* scale groups, layer selectors, ``quantize_network`` (every field, from
  the same folded params and absmax), the int8 conv's two routes, the
  int8 maxpool, the int8 canvas, the quantile of ``jnp.quantile``
  (float32 linear interpolation, also above 2^24 elements) and artifacts
  read back: equal.
* ``collect_act_absmax``: 1e-5 relative per layer (fp32 convolutions on
  both sides that sum in other orders).
* ``forward_quantized`` all-int8, against the JAX function run op by op:
  the int8 input of every int8 conv equal, raw maps within 1e-6 of their
  largest magnitude and in fact equal (equal codes enter the same head
  epilogue, so they are held equal). Under ``jax.jit`` XLA's CPU
  compiler fuses the epilogue's multiply and add into one rounding, which
  moves codes at rounding ties; the port keeps the function's written
  order. Hybrid under BITMATCH: codes at most one step apart (the fp32
  float convs sum in other orders; the share that differs is asserted
  below 1%), raw maps within 1e-4 of their largest magnitude.
* The eval CLI, FAST, against the JAX CLI (jitted, bf16 letterbox): the
  mAP within 10% relative of a nonzero JAX mAP, as the FAST tolerance of
  the other eval tests; the NMS lines equal. An artifact saved by either
  CLI and served by the port's ``eval --qmodel`` prints the port's
  ``--int8`` summary line for line (the throughput lines excepted).
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.cli import eval as jeval_cli
from modelcompression_tpu.compress import quantize as jq
from modelcompression_tpu.core.precision import BITMATCH as J_BITMATCH
from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.data.preprocess import (
    quantize_canvas as j_quantize_canvas,
)
from modelcompression_tpu.models import cfg as jcfg
from modelcompression_tpu.models import darknet as jdn
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import save_weights as j_save
from modelcompression_tpu_torch.cli import eval as teval_cli
from modelcompression_tpu_torch.compress import quantize as tq
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.data import preprocess as tpre
from modelcompression_tpu_torch.evaluation import pipeline as tpipe
from modelcompression_tpu_torch.models import cfg as tcfg
from modelcompression_tpu_torch.models import darknet as tdn
from modelcompression_tpu_torch.models.convert import params_from_jax
from modelcompression_tpu_torch.ops import int8_conv as ti8
from tests.test_torch_darknet import random_np_params

NET = 64
POOL_FIRST = """
[net]
height=32
width=32
channels=3

[maxpool]
size=2
stride=2

[convolutional]
filters=8
size=1
stride=1
pad=0
activation=leaky

[convolutional]
filters=33
size=1
stride=1
pad=0
activation=linear

[region]
anchors = 1.0,1.0
classes=6
num=1
"""
KINDS = {
    "region": lambda: jfx.tiny_region_cfg(num_classes=3, width=NET,
                                          height=NET),
    "v3_tiny": lambda: jfx.tiny_yolo3_cfg(num_classes=3, width=NET,
                                          height=NET),
    "v4_tiny": lambda: jfx.tiny_yolo4_cfg(num_classes=3, width=NET,
                                          height=NET),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _yolov2_voc_64():
    """YOLOv2-VOC at full width (its route and reorg, the route group's
    shared scale), cut to a 64 px input."""
    path = os.path.join(os.path.dirname(jcfg.__file__), "..", "configs",
                        "yolov2-voc.cfg")
    with open(path) as f:
        return f.read().replace("width=416", f"width={NET}").replace(
            "height=416", f"height={NET}")


def _specs(kind):
    text = (POOL_FIRST if kind == "pool_first" else _yolov2_voc_64()
            if kind == "yolov2_voc" else KINDS[kind]())
    return jcfg.parse_cfg(text), tcfg.parse_cfg(text)


@functools.lru_cache(maxsize=None)
def _folded(kind, seed=3):
    """The same BN-folded params on both sides: folded by the JAX
    package, carried across HWIO -> OIHW (cached: no test writes them)."""
    js, ts = _specs(kind)
    npp = random_np_params(js, seed=seed)
    jfold = jax.tree.map(np.asarray, jdn.fold_batchnorm(
        jax.tree.map(jnp.asarray, npp), js))
    return js, ts, jfold, params_from_jax(jfold, ts)


def _batches(n=2, b=2, seed=4, net=NET):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (b, net, net, 3)).astype(np.float32)
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_absmax(kind):
    js, _, jfold, _ = _folded(kind)
    return jq.collect_act_absmax(jfold, js, _batches())


def _calibrated(kind, int8_layers=None):
    js, ts, jfold, tfold = _folded(kind)
    absmax, in_max = _jax_absmax(kind)
    jqp = jq.quantize_network(jfold, js, absmax, in_max,
                              int8_layers=int8_layers)
    tqp = tq.quantize_network(tfold, ts, absmax, in_max,
                              int8_layers=int8_layers)
    return js, ts, jqp, tqp


def _hybrid_subset(spec):
    return spec.conv_indices()[1::2]


def _tuple(y):
    return y if isinstance(y, tuple) else (y,)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- scale groups, selectors, quantize_network ---------------------------

@pytest.mark.parametrize("kind", ["region", "v3_tiny", "v4_tiny",
                                  "pool_first", "yolov2_voc"])
def test_scale_groups_and_selectors_equal_jax(kind):
    js, ts = _specs(kind)
    assert tq._scale_groups(ts) == jq._scale_groups(js)
    for k in (128, 64, 16, 8):
        assert tq.int8_layers_auto(ts, k) == jq.int8_layers_auto(js, k)
    assert tq.int8_layers_auto(ts) == jq.int8_layers_auto(js)
    convs = ",".join(str(i) for i in ts.conv_indices()[:2])
    for sel in ("all", "auto", "AUTO:16", convs):
        assert tq.resolve_int8_layers(ts, sel) == \
            jq.resolve_int8_layers(js, sel)
    absmax = np.linspace(0.5, 9.0, len(js.layers))
    assert tq._layer_out_scales(ts, absmax, 1.0) == \
        jq._layer_out_scales(js, absmax, 1.0)
    with pytest.raises(ValueError, match="not conv"):
        tq._resolve_int8_set(ts, [len(ts.layers) - 1])


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("hybrid", [False, True])
def test_quantize_network_bit_equal_to_jax(kind, hybrid):
    js = _specs(kind)[0]
    sub = _hybrid_subset(js) if hybrid else None
    _, _, jqp, tqp = _calibrated(kind, sub)
    assert tqp.keys() == jqp.keys()
    for key, entry in jqp.items():
        assert tqp[key].keys() == entry.keys(), key
        for field, want in entry.items():
            got = tqp[key][field].numpy()
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{key}/{field}")


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("quantile", [None, 0.999])
def test_collect_act_absmax_matches_jax(kind, quantile):
    js, ts, jfold, tfold = _folded(kind)
    batches = _batches()
    want, want_in = jq.collect_act_absmax(jfold, js, batches,
                                          quantile=quantile)
    got, got_in = tq.collect_act_absmax(tfold, ts, batches,
                                        quantile=quantile)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got_in == pytest.approx(want_in, rel=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 100003, 2 ** 24 + 12345])
def test_abs_quantiles_equal_jnp_quantile(n):
    """Above 2^24 elements the float32 position q·(n − 1) itself rounds;
    the port reproduces it, and the interpolation's rounding."""
    rng = np.random.default_rng(n % 97)
    a = (rng.standard_normal(n) * 3.0).astype(np.float32)
    # jnp.quantile sorts its input; handing it |a| sorted already (the
    # same multiset, so the same quantile) halves its time at 2^24
    abs_sorted = jnp.asarray(np.sort(np.abs(a)))
    for q in ((0.999,) if n > 2 ** 24 else (0.5, 0.9, 0.999, 0.1234567)):
        want = np.float32(jnp.quantile(abs_sorted, q))
        got = tq.abs_quantiles([torch.from_numpy(a)], q)[0]
        assert got == want, (n, q)


# ---- forward_quantized -------------------------------------------------------

def _jax_int8_inputs(qparams, x, spec, precision):
    """JAX's forward_quantized, op by op, and the int8 input of each of
    its int8 convs."""
    got = []
    orig = jax.lax.conv_general_dilated

    def record(lhs, rhs, *a, **kw):
        if lhs.dtype == jnp.int8:
            got.append(np.asarray(lhs))
        return orig(lhs, rhs, *a, **kw)

    jax.lax.conv_general_dilated = record
    try:
        y = jq.forward_quantized(qparams, jnp.asarray(x), spec, precision)
    finally:
        jax.lax.conv_general_dilated = orig
    return _tuple(y), got


def _port_int8_inputs(qparams, x, spec, precision, monkeypatch):
    got = []
    orig = tq.int8_conv

    def record(x_q, w_q, stride, padding):
        got.append(x_q.numpy().copy())
        return orig(x_q, w_q, stride, padding)

    monkeypatch.setattr(tq, "int8_conv", record)
    y = tq.forward_quantized(qparams, torch.from_numpy(x), spec, precision)
    monkeypatch.setattr(tq, "int8_conv", orig)
    return _tuple(y), got


@pytest.mark.parametrize("kind", sorted(KINDS) + ["yolov2_voc"])
def test_forward_quantized_all_int8_equals_jax(kind, monkeypatch):
    js, ts, jqp, tqp = _calibrated(kind)
    x = _batches(n=1, seed=5)[0]
    jy, jin = _jax_int8_inputs(jqp, x, js, J_BITMATCH)
    ty, tin = _port_int8_inputs(tqp, x, ts, BITMATCH, monkeypatch)
    assert len(tin) == len(jin) == len(ts.conv_indices())
    for i, (a, b) in enumerate(zip(tin, jin)):
        np.testing.assert_array_equal(a, b, err_msg=f"int8 conv {i}")
    assert len(ty) == len(jy)
    for a, b in zip(ty, jy):
        assert a.dtype == torch.float32 and a.shape == b.shape
        # the same codes into the same head epilogue: held equal, inside
        # the 1e-6 of their largest magnitude the comparison allows
        assert _rel(a.numpy(), b) <= 1e-6
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_quantized_hybrid_bitmatch_tracks_jax(kind, monkeypatch):
    js = _specs(kind)[0]
    js, ts, jqp, tqp = _calibrated(kind, _hybrid_subset(js))
    x = _batches(n=1, seed=6)[0]
    jy, jin = _jax_int8_inputs(jqp, x, js, J_BITMATCH)
    ty, tin = _port_int8_inputs(tqp, x, ts, BITMATCH, monkeypatch)
    assert len(tin) == len(jin) == len(_hybrid_subset(js))
    n_diff = n_all = 0
    for a, b in zip(tin, jin):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1
        n_diff += int((d > 0).sum())
        n_all += d.size
    assert n_diff / n_all < 0.01
    for a, b in zip(ty, jy):
        assert _rel(a.numpy(), b) <= 1e-4


def test_int8_input_canvas_bit_equals_the_float_route():
    """An int8 canvas on the pytree's own input grid gives the float
    canvas's forward bit for bit, as does the eval step with int8_input
    (device letterbox and pre-letterboxed canvases); the canvas equals
    the JAX package's quantize of the same floats."""
    _, ts, _, tqp = _calibrated("region")
    qs = tqp["__net__"]["input_scale"]
    x = torch.from_numpy(_batches(n=1, seed=7)[0])
    x8 = tpre.quantize_canvas(x, qs)
    np.testing.assert_array_equal(
        x8.numpy(), np.asarray(j_quantize_canvas(jnp.asarray(x.numpy()),
                                                 float(qs))))
    np.testing.assert_array_equal(
        tq.forward_quantized(tqp, x, ts).numpy(),
        tq.forward_quantized(tqp, x8, ts).numpy())
    rng = np.random.default_rng(8)
    cfg = tpipe.EvalConfig(batch_size=2, max_detections=10,
                           conf_thresh=0.01, device="cpu",
                           forward_fn=tq.forward_quantized)
    cfg8 = tpipe.EvalConfig(batch_size=2, max_detections=10,
                            conf_thresh=0.01, device="cpu",
                            forward_fn=tq.forward_quantized,
                            int8_input=True)
    w, h = np.array([80.0, 80.0]), np.array([48.0, 48.0])
    for src_hw in ((48, 80), None):
        shape = (2, *src_hw, 3) if src_hw else (2, NET, NET, 3)
        imgs = rng.integers(0, 255, shape, np.uint8)
        out = tpipe.make_eval_step(ts, cfg, src_hw)(tqp, imgs, w, h)
        out8 = tpipe.make_eval_step(ts, cfg8, src_hw)(tqp, imgs, w, h)
        for a, b in zip(out, out8):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    frames = torch.from_numpy(rng.integers(0, 255, (2, 48, 80, 3),
                                           np.uint8))
    for dtype in (torch.float32, torch.bfloat16):
        want = tpre.quantize_canvas(
            tpre.letterbox_device(frames, NET, NET, dtype=dtype), qs)
        got = tpre.letterbox_device(frames, NET, NET, dtype=dtype,
                                    quant_scale=qs)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        want = tpre.quantize_canvas(
            tpre.stretch_resize_device(frames, NET, NET, dtype=dtype), qs)
        np.testing.assert_array_equal(
            tpre.stretch_resize_device(frames, NET, NET, dtype=dtype,
                                       quant_scale=qs).numpy(),
            want.numpy())


# ---- the int8 conv and the int8 maxpool ------------------------------------

@pytest.mark.parametrize("b, hw, c, k, n, stride", [
    (2, 9, 3, 3, 16, 1),     # conv1: 27 taps padded to 32
    (3, 4, 24, 1, 125, 1),   # a 125-channel head: width padded to 128
    (2, 10, 16, 1, 75, 1),   # YOLOv4's 75-channel heads
    (2, 10, 5, 3, 7, 2),     # a stride-2 3x3
    (1, 3, 8, 3, 8, 1),      # 9 rows: padded to 17
])
def test_int8_conv_routes_equal_the_exact_sums(b, hw, c, k, n, stride):
    """The card route's im2col / padding / GEMM arithmetic, run on the
    CPU's ``_int_mm``, equals the plain float64 route, which equals int64
    sums; the dispatcher takes the plain route on the CPU; the card
    route refuses a CPU tensor."""
    g = torch.Generator().manual_seed(b * 100 + n)
    x = torch.randint(-127, 128, (b, hw, hw, c), dtype=torch.int8,
                      generator=g)
    w = torch.randint(-127, 128, (k, k, c, n), dtype=torch.int8,
                      generator=g)
    pad = k // 2
    plain = ti8.int8_conv_plain(x, w, stride, pad)
    x64 = torch.nn.functional.pad(x.long(), (0, 0, pad, pad, pad, pad))
    win = x64.unfold(1, k, stride).unfold(2, k, stride)  # B,Ho,Wo,C,k,k
    want = torch.einsum("bhwcij,ijcn->bhwn", win, w.long()).to(torch.int32)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want.numpy())
    np.testing.assert_array_equal(
        ti8.int8_gemm_conv(x, w, stride, pad).numpy(), want.numpy())
    n0 = ti8.int8_conv_cuda.LAUNCHES
    np.testing.assert_array_equal(ti8.int8_conv(x, w, stride, pad).numpy(),
                                  want.numpy())
    assert ti8.int8_conv_cuda.LAUNCHES == n0
    with pytest.raises(ValueError, match="CUDA"):
        ti8.int8_conv_cuda(x, w, stride, pad)
    with pytest.raises(ValueError, match="int8"):
        ti8.int8_conv(x.float(), w, stride, pad)


def test_int8_layout_ops_are_dtype_free():
    """reorg, nearest upsample and the route concat move int8 values as
    they move floats."""
    g = torch.Generator().manual_seed(1)
    x8 = torch.randint(-127, 128, (2, 6, 8, 8), dtype=torch.int8,
                       generator=g)
    for op in (lambda t: tdn.reorg(t, 2),
               lambda t: tdn.upsample_nearest(t, 2),
               lambda t: torch.cat([t, t.flip(1)], dim=1)):
        got = op(x8)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(),
                                      op(x8.float()).to(torch.int8).numpy())


@pytest.mark.parametrize("size, stride", [(2, 2), (2, 1), (5, 1)])
def test_int8_maxpool_is_exact_and_matches_jax(size, stride):
    """int8 pools exactly, pads with -128 as the JAX package does (a
    window of all padding cannot occur; an all-negative edge keeps its
    own max), and the float path is unchanged."""
    layer = tcfg.MaxPoolLayer(size=size, stride=stride)
    jlayer = jcfg.MaxPoolLayer(size=size, stride=stride)
    g = torch.Generator().manual_seed(size * 10 + stride)
    x8 = torch.randint(-127, 128, (2, 6, 7, 9), dtype=torch.int8,
                       generator=g)
    got = tdn.maxpool(x8, layer)
    assert got.dtype == torch.int8
    want = np.asarray(jdn.maxpool(jnp.asarray(x8.permute(0, 2, 3, 1)
                                              .numpy()), jlayer))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tdn.maxpool(x8.float(), layer).to(torch.int8).numpy())
    xf = torch.randn(2, 9, 6, 7, generator=g)
    np.testing.assert_array_equal(
        tdn.maxpool(xf, layer).numpy(),
        np.asarray(jdn.maxpool(jnp.asarray(xf.permute(0, 2, 3, 1).numpy()),
                               jlayer)).transpose(0, 3, 1, 2))


# ---- the artifact ---------------------------------------------------------------

@pytest.mark.parametrize("kind, hybrid", [("region", False),
                                          ("v3_tiny", True),
                                          ("v4_tiny", False)])
def test_qmodel_artifacts_load_in_the_other_package(kind, hybrid,
                                                    tmp_path):
    """An artifact written by either package loads in the other, key for
    key and bit for bit: the port serves the JAX artifact's maps equal to
    its own pytree's, and the JAX package reads back the port's pytree
    field for field."""
    js = _specs(kind)[0]
    js, ts, jqp, tqp = _calibrated(kind, _hybrid_subset(js) if hybrid
                                   else None)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jq.save_qmodel(jpath, jqp, js)
    tq.save_qmodel(tpath, tqp, ts)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    t_from_j, t_spec = tq.load_qmodel(jpath, spec=ts)
    assert t_spec is ts
    j_from_t, _ = jq.load_qmodel(tpath, spec=js)
    x = torch.from_numpy(_batches(n=1, seed=9)[0])
    for a, b in zip(_tuple(tq.forward_quantized(t_from_j, x, ts)),
                    _tuple(tq.forward_quantized(tqp, x, ts))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert j_from_t.keys() == jqp.keys()
    for key, entry in jqp.items():
        assert j_from_t[key].keys() == entry.keys()
        for field, want in entry.items():
            got = np.asarray(j_from_t[key][field])
            assert got.dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, np.asarray(want))


def test_qmodel_guards(tmp_path):
    """The architecture guard; and the packed format (refused, naming
    ROADMAP item 6e, until it was ported): written and read by the port,
    and a JAX-packed artifact read, both to the saved pytree exactly."""
    js, ts, jqp, tqp = _calibrated("region")
    path = str(tmp_path / "q.npz")
    tq.save_qmodel(path, tqp, ts)
    other = tcfg.parse_cfg(jfx.tiny_region_cfg(num_classes=3, width=96,
                                               height=96))
    with pytest.raises(ValueError, match="different architecture"):
        tq.load_qmodel(path, spec=other)
    tq.save_qmodel(path, tqp, ts, pack="huffman")
    with pytest.raises(ValueError, match="different architecture"):
        tq.load_qmodel(path, spec=other)
    got, _ = tq.load_qmodel(path)
    jq.save_qmodel(path, jqp, js, pack="huffman")
    from_jax, _ = tq.load_qmodel(path)
    for k, e in tqp.items():
        for f, v in e.items():
            assert torch.equal(got[k][f], v), (k, f)
            assert torch.equal(from_jax[k][f], v), (k, f)


# ---- the eval CLI -------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    """A tiny region model at 96 px written as .weights by the JAX
    package, and a 5-image fixture at 96 px."""
    tmp = tmp_path_factory.mktemp("int8_cli")
    text = jfx.tiny_region_cfg(num_classes=3, width=96, height=96)
    cfg = str(tmp / "net.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    spec = jcfg.parse_cfg(text)
    weights = str(tmp / "w.weights")
    j_save(weights, spec, jax.tree.map(
        np.asarray, j_init(spec, jax.random.key(2))), seen=0)
    data = jfx.make_fake_voc(str(tmp / "d"), n_images=5, image_size=96,
                             seed=2)
    return cfg, weights, data


_MAP = re.compile(r"^mAP@[0-9.]+ \([^)]*\): ([0-9.]+)", re.M)


def _summary(out):
    """The summary without the throughput figures."""
    return [re.sub(r"\[.*img/s.*\]", "", l) for l in out.splitlines()
            if not l.startswith("throughput")]


@pytest.mark.parametrize("extra", [
    [], ["--calib-quantile", "0.999"], ["--int8-layers", "auto:8"],
    ["--pack"]])
def test_eval_cli_int8_matches_jax_and_its_artifact(cli_model, capsys,
                                                    tmp_path, extra):
    cfg, weights, data = cli_model
    base = ["--cfg", cfg, "--data", data, "--batch", "2", "--map-iou",
            "0.1", "--calib-images", "5"]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jeval_cli.main(base + ["--weights", weights, "--int8",
                                  "--save-qmodel", jpath, *extra]) == 0
    want = capsys.readouterr().out
    assert teval_cli.main(base + ["--weights", weights, "--int8",
                                  "--save-qmodel", tpath, "--device", "cpu",
                                  *extra]) == 0
    got = capsys.readouterr().out
    (w,), (g,) = _MAP.findall(want), _MAP.findall(got)
    assert float(w) > 0 and abs(float(g) - float(w)) <= 0.1 * float(w)
    assert [l for l in got.splitlines() if l.startswith("NMS:")] == \
        [l for l in want.splitlines() if l.startswith("NMS:")]
    for path in (tpath, jpath):
        assert teval_cli.main(base + ["--qmodel", path,
                                      "--device", "cpu"]) == 0
        served = capsys.readouterr().out
        if path == tpath:
            assert _summary(served) == _summary(got)
        else:
            (s,) = _MAP.findall(served)
            assert abs(float(s) - float(w)) <= 0.1 * float(w)


@pytest.mark.parametrize("extra, message", [
    (["--int8", "--precision", "bitmatch"], "cannot bit-match"),
    (["--int8", "--int8-layers", "1,2"], "not conv layers"),
    (["--int8", "--int8-layers", "auto:x"], "bad --int8-layers"),
    # the id of the case that refused --pack (ROADMAP item 6e) before it
    # was ported; --pack without an artifact is the JAX CLI's usage error
    pytest.param(["--int8", "--pack"], "--pack entropy-codes",
                 id="extra3-item 6e"),
])
def test_eval_cli_int8_rejections(cli_model, capsys, extra, message):
    cfg, weights, data = cli_model
    assert teval_cli.main(["--cfg", cfg, "--weights", weights, "--data",
                           data, "--device", "cpu", *extra]) == 2
    assert message in capsys.readouterr().err


def test_eval_cli_qmodel_architecture_guard(cli_model, capsys, tmp_path):
    cfg, weights, data = cli_model
    js, ts, _, tqp = _calibrated("region")
    path = str(tmp_path / "q.npz")
    tq.save_qmodel(path, tqp, ts)  # a 64 px model, the cfg is 96 px
    assert teval_cli.main(["--cfg", cfg, "--qmodel", path, "--data", data,
                           "--device", "cpu"]) == 2
    assert "different architecture" in capsys.readouterr().err
