"""The port's quantization-aware training pieces (compress/qat.py and the
train step's QAT hooks) against the JAX package's, on the CPU.

Tolerances:
* ``fake_quant`` / ``fake_quant_weight`` forward values: equal to the JAX
  functions run op by op (fp32 ``x + (q - x)``, true division; under
  ``jax.jit`` XLA's CPU compiler fuses ``q·s - x`` into one rounding and
  turns the division by the constant 127 into a reciprocal multiply, an
  ulp away). The STE gradient: exactly the identity.
* The QAT plan (``QATSpec``) and ``quantize_qat`` from the same params
  and calibration: equal (the calibration itself within 1e-5 relative,
  as ``collect_act_absmax``'s test; the plan is built from one profile).
* The QAT training forward on a BN-free net against the deployed int8
  forward of its export: normalized RMS error below 1e-3, the JAX
  package's own bound for the same check.
The QAT train step against JAX's is in ``tests/test_torch_train_step.py``;
``finetune --qat --save-qmodel`` in ``tests/test_torch_train_loop.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.compress import qat as jqat
from modelcompression_tpu.compress import quantize as jq
from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.models import cfg as jcfg
from modelcompression_tpu_torch.compress import qat as tqat
from modelcompression_tpu_torch.compress import quantize as tq
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.models import cfg as tcfg
from modelcompression_tpu_torch.models.convert import params_from_jax
from modelcompression_tpu_torch.train.train_step import _forward_train
from tests.test_qat import NO_BN_CFG
from tests.test_torch_darknet import random_np_params


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scale", [0.01, 0.0371, 1.0 / 127.0])
def test_fake_quant_equals_jax_with_identity_gradient(scale):
    rng = np.random.default_rng(int(scale * 1e4))
    x = np.concatenate([rng.normal(0, 2.0, 5000),
                        [-300.0, -1.27, -0.004, 0.0, 0.004, 300.0]]
                       ).astype(np.float32)
    want = np.asarray(jqat.fake_quant(jnp.asarray(x), scale))
    t = torch.from_numpy(x).requires_grad_(True)
    got = tqat.fake_quant(t, scale)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    (got * g).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), g.numpy())
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tqat.fake_quant(xb, scale).dtype == torch.bfloat16


def test_fake_quant_weight_equals_jax_with_identity_gradient():
    """Per output channel of the OIHW weight, as JAX's over HWIO's first
    three axes; a zero channel takes the 1e-12 floor."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.1, (3, 3, 16, 32)).astype(np.float32)
    w[..., 5] = 0.0
    want = np.asarray(jqat.fake_quant_weight(jnp.asarray(w)))
    t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))
                         ).requires_grad_(True)
    got = tqat.fake_quant_weight(t)
    np.testing.assert_array_equal(got.detach().numpy().transpose(2, 3, 1, 0),
                                  want)
    got.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.ones(t.shape))


def _setup(kind, seed=3):
    text = (NO_BN_CFG if kind == "no_bn"
            else jfx.tiny_yolo3_cfg(num_classes=3, width=64, height=64)
            if kind == "v3_tiny"
            else jfx.tiny_region_cfg(num_classes=3, width=64, height=64))
    js, ts = jcfg.parse_cfg(text), tcfg.parse_cfg(text)
    npp = random_np_params(js, seed=seed)
    rng = np.random.default_rng(seed + 1)
    calib = [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)]
    return js, ts, npp, calib


@pytest.mark.parametrize("kind", ["region", "v3_tiny", "no_bn"])
@pytest.mark.parametrize("subset", [None, "odd"])
def test_qat_plan_and_export_equal_jax(kind, subset):
    js, ts, npp, calib = _setup(kind)
    sel = js.conv_indices()[1::2] if subset else None
    jspec = jqat.qat_spec_from_batches(jax.tree.map(jnp.asarray, npp), js,
                                       calib, int8_layers=sel)
    tspec = tqat.qat_spec_from_batches(params_from_jax(npp, ts), ts, calib,
                                       int8_layers=sel)
    np.testing.assert_allclose(tspec.act_absmax, jspec.act_absmax,
                               rtol=1e-5, atol=0)
    # one plan from one profile: the JAX calibration through both
    got = tqat.qat_spec_from_absmax(ts, jspec.act_absmax,
                                    jspec.input_absmax, int8_layers=sel)
    assert got == tqat.QATSpec(**vars(jspec))
    want_q = jqat.quantize_qat(jax.tree.map(jnp.asarray, npp), js, jspec)
    got_q = tqat.quantize_qat(params_from_jax(npp, ts), ts, got)
    assert got_q.keys() == want_q.keys()
    for key, entry in want_q.items():
        for field, want in entry.items():
            g, w = got_q[key][field].numpy(), np.asarray(want)
            if field == "w_q":
                # the BN fold differs by an fp32 ulp between the packages,
                # which can move a weight across a rounding tie
                assert np.abs(g.astype(np.int32) - w).max() <= 1, key
            elif key == "__net__" or field in ("in_scale", "out_scale"):
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_qat_forward_matches_deployed_int8():
    """On a BN-free net the QAT training forward (fp32 fake-quant) tracks
    the deployed int8 forward of its export: same grids, same boundary
    placement, fp32-rounded against exact int32 sums."""
    js, ts, npp, calib = _setup("no_bn")
    params = params_from_jax(npp, ts)
    x = torch.from_numpy(calib[0])
    for sel in (None, [0], [2, 4]):
        plan = tqat.qat_spec_from_batches(params, ts, calib,
                                          int8_layers=sel)
        got, stats = _forward_train(params, x, ts, BITMATCH, {}, qat=plan)
        assert not stats
        ref = tq.forward_quantized(tqat.quantize_qat(params, ts, plan), x,
                                   ts, BITMATCH).numpy()
        got = got.detach().numpy()
        nrmse = np.sqrt(np.mean((got - ref) ** 2)) / (np.std(ref) + 1e-12)
        assert nrmse < 1e-3, (sel, nrmse)
    with pytest.raises(ValueError, match="not conv"):
        tqat.qat_spec_from_batches(params, ts, calib, int8_layers=[1])
