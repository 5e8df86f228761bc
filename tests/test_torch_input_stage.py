"""The port's fused input stage (modelcompression_tpu_torch/ops/
input_stage.py) against the JAX package's: the plain PyTorch version vs
``fused_conv1_pool_xla`` and vs ``fused_conv1_pool_pallas`` run in
interpret mode (as tests/test_input_stage.py runs it), for the unpruned
(C=32), tiny (C=16) and 75%-pruned (C=8) filter counts.

Tolerances: fp32 — both sides sum the same 27 fp32 products per phase
in different orders, so atol 1e-5 on outputs of order 1. bf16 — the
``_assert_close`` tolerance of tests/test_input_stage.py (atol 3% of the
largest magnitude, rtol 5%): both sides round the result to bf16 once,
and a summation-order difference can move that rounding by one bf16 ulp.
The direct GEMM form of the tensor-core kernel (``pack_mma_weights`` and
its im2col, rebuilt here) is held against ``fused_conv1_pool_xla`` too.
The CUDA kernels are held against the plain version on the card in
tests/test_torch_cuda_kernels.py."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.ops import input_stage as jis
from modelcompression_tpu_torch.ops import input_stage as tis

FP32_ATOL = 1e-5


def _assert_close_bf16(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got, want, atol=0.03 * scale, rtol=0.05)


def _rand_case(c_out, h=32, w=64, b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    w_hwio = rng.normal(0, 0.2, (3, 3, 3, c_out)).astype(np.float32)
    bias = rng.normal(0, 0.5, (c_out,)).astype(np.float32)
    return x, w_hwio, bias


def _port(x, w_hwio, bias, dtype):
    w_oihw = torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1)))
    out = tis.fused_conv1_pool_plain(torch.from_numpy(x), w_oihw,
                                     torch.from_numpy(bias),
                                     compute_dtype=dtype)
    return out.float().numpy()


_DTYPES = {"fp32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}


def _check(got, want, dt):
    if dt == "fp32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    else:
        _assert_close_bf16(got, want)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("c_out", [8, 16, 32])
def test_plain_matches_jax_xla_twin(c_out, dt):
    x, w, b = _rand_case(c_out, seed=c_out)
    tdt, jdt = _DTYPES[dt]
    want = np.asarray(jis.fused_conv1_pool_xla(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), compute_dtype=jdt),
        np.float32)
    got = _port(x, w, b, tdt)
    assert got.shape == want.shape == (2, 16, 32, c_out)
    _check(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("c_out", [8, 16, 32])
def test_plain_matches_jax_pallas_interpret(c_out, dt):
    x, w, b = _rand_case(c_out, h=64, w=64, b=3, seed=10 + c_out)
    tdt, jdt = _DTYPES[dt]
    want = np.asarray(jis.fused_conv1_pool_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), compute_dtype=jdt,
        tile_h=16, interpret=True), np.float32)
    _check(_port(x, w, b, tdt), want, dt)


def test_plain_equals_conv_pool_fp32():
    """The identity behind the fusion: pool(leaky(conv + b)) in fp32."""
    x, w, b = _rand_case(8, h=20, w=14, seed=3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    y = torch.nn.functional.conv2d(xt, wt, torch.from_numpy(b), padding=1)
    want = torch.nn.functional.max_pool2d(
        torch.nn.functional.leaky_relu(y, 0.1), 2).permute(0, 2, 3, 1)
    got = tis.fused_conv1_pool_plain(torch.from_numpy(x), wt,
                                     torch.from_numpy(b), torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FP32_ATOL,
                               rtol=0)


def test_tap_matrix_equals_jax():
    np.testing.assert_array_equal(tis._tap_matrix(), jis._tap_matrix())
    m = tis._tap_matrix()
    assert m.shape == (108, 4, 3, 3, 3)
    assert m.sum() == 4 * 27
    assert (m.reshape(108, 4, 27).sum(axis=0) == 1).all()


@pytest.mark.parametrize("c_out", [8, 32])
def test_s2d_weights_equal_jax(c_out):
    _, w, _ = _rand_case(c_out, seed=c_out + 1)
    want = np.asarray(jis.s2d_weights(jnp.asarray(w)))
    got = tis.s2d_weights(torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1)))).numpy()
    np.testing.assert_array_equal(got, want)


def test_space_to_depth2_equals_jax():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    np.testing.assert_array_equal(
        tis.space_to_depth2(torch.from_numpy(x)).numpy(),
        np.asarray(jis.space_to_depth2(jnp.asarray(x))))


def test_dispatcher_uses_plain_on_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel wrapper reached with a CPU tensor")
    for name in ("fused_conv1_pool_f32", "fused_conv1_pool_mma"):
        monkeypatch.setattr(tis, name, boom)
    x, w, b = _rand_case(8, h=8, w=8, seed=5)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tis.fused_conv1_pool(torch.from_numpy(x), wt, torch.from_numpy(b),
                               torch.float32)
    np.testing.assert_array_equal(got.numpy(), _port(x, w, b,
                                                     torch.float32))


def _fake_cuda_tensor():
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    fake.to = lambda dtype: fake
    return fake


def _spy_kernels(monkeypatch):
    """Replace the plain version (must not be reached) and the kernel
    wrappers (record which one was called)."""
    calls = []

    def plain(*a, **k):
        raise AssertionError("plain version reached with a CUDA tensor")

    def mma(x, w, b):
        calls.append("mma")
        return "mma-output"

    def f32(x, w, b):
        calls.append("f32")
        return "f32-output"
    monkeypatch.setattr(tis, "fused_conv1_pool_plain", plain)
    monkeypatch.setattr(tis, "fused_conv1_pool_mma", mma)
    monkeypatch.setattr(tis, "fused_conv1_pool_f32", f32)
    return calls


def test_dispatcher_never_sends_cuda_tensor_to_plain(monkeypatch):
    """A CUDA tensor goes to a kernel wrapper or raises; the plain
    version is never reached (no fallback). The default (bf16) goes to
    the tensor-core kernel."""
    calls = _spy_kernels(monkeypatch)
    assert tis.fused_conv1_pool(_fake_cuda_tensor(), None, None) == \
        "mma-output"
    assert calls == ["mma"]


@pytest.mark.parametrize("dtype, want", [
    (torch.bfloat16, "mma"), (torch.float32, "f32")])
def test_dispatcher_routes_cuda_tensor_by_dtype(monkeypatch, dtype, want):
    """bf16 to the mma kernel, fp32 to the fp32 CUDA-core kernel, each
    once."""
    calls = _spy_kernels(monkeypatch)
    tis.fused_conv1_pool(_fake_cuda_tensor(), None, None, dtype)
    assert calls == [want]


def test_dispatcher_rejects_other_dtypes_on_cuda(monkeypatch):
    """fp16 has no kernel: a CUDA tensor raises, reaching no wrapper."""
    calls = _spy_kernels(monkeypatch)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tis.fused_conv1_pool(_fake_cuda_tensor(), None, None, torch.float16)
    assert calls == []


def test_dispatcher_rejects_other_devices():
    x = torch.empty((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tis.fused_conv1_pool(x, torch.empty(8, 3, 3, 3), torch.empty(8))


@pytest.mark.parametrize("wrapper, kernel, dtype", [
    ("fused_conv1_pool_mma", "MMA", torch.bfloat16),
    ("fused_conv1_pool_f32", "F32", torch.float32),
])
def test_kernel_wrapper_rejects_cpu_tensor(wrapper, kernel, dtype):
    """A CPU tensor in the wrapper's own dtype raises before any launch
    of its kernel is counted."""
    k = getattr(tis, kernel)
    before, before_at = k.launches, dict(k.at)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(tis, wrapper)(torch.zeros((1, 4, 4, 3), dtype=dtype),
                              torch.zeros((8, 3, 3, 3)), torch.zeros(8))
    assert k.launches == before
    assert dict(k.at) == before_at


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("x, w_shape, msg", [
    (_bf16((1, 4, 4, 3)), (8, 3, 3, 3), "CUDA tensor"),
    (torch.zeros((1, 4, 4, 3)), (8, 3, 3, 3), "bf16"),
    (_bf16((1, 4, 4, 3)), (33, 3, 3, 3), "C <= 32"),
    (_bf16((1, 5, 4, 3)), (8, 3, 3, 3), "even"),
    (_bf16((1, 4, 7, 3)), (8, 3, 3, 3), "even"),
])
def test_mma_wrapper_rejects(x, w_shape, msg):
    """A CPU tensor, fp32, C = 33 and odd H or W raise before any launch."""
    before, before_at = tis.MMA.launches, dict(tis.MMA.at)
    with pytest.raises(ValueError, match=msg):
        tis.fused_conv1_pool_mma(x, torch.zeros(w_shape),
                                 torch.zeros(w_shape[0]))
    assert tis.MMA.launches == before
    assert dict(tis.MMA.at) == before_at


@pytest.mark.parametrize("x, w_shape, msg", [
    (torch.zeros((1, 4, 4, 3)), (8, 3, 3, 3), "CUDA tensor"),
    (_bf16((1, 4, 4, 3)), (8, 3, 3, 3), "fp32"),
    (torch.zeros((1, 4, 4, 3)), (33, 3, 3, 3), "C <= 32"),
    (torch.zeros((1, 5, 4, 3)), (8, 3, 3, 3), "even"),
    (torch.zeros((1, 4, 7, 3)), (8, 3, 3, 3), "even"),
])
def test_f32_wrapper_rejects(x, w_shape, msg):
    """A CPU tensor, bf16 x, C = 33 and odd H or W raise before any
    launch."""
    before, before_at = tis.F32.launches, dict(tis.F32.at)
    with pytest.raises(ValueError, match=msg):
        tis.fused_conv1_pool_f32(x, torch.zeros(w_shape),
                                 torch.zeros(w_shape[0]))
    assert tis.F32.launches == before
    assert dict(tis.F32.at) == before_at


@pytest.mark.parametrize("c_out", [1, 8, 13, 32])
def test_pack_mma_weights_layout(c_out):
    _, w, _ = _rand_case(c_out, seed=c_out + 2)
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    wp = tis.pack_mma_weights(w_oihw.to(torch.bfloat16))
    n_pad = -(-c_out // 8) * 8
    assert wp.shape == (n_pad, 32) and wp.dtype == torch.bfloat16
    assert wp.is_contiguous()
    assert not wp[c_out:].any() and not wp[:, 27:].any()
    want = w_oihw.to(torch.bfloat16)
    for ky in range(3):
        for kx in range(3):
            for ci in range(3):
                k = (ky * 3 + kx) * 3 + ci
                assert torch.equal(wp[:c_out, k], want[:, ci, ky, kx])


def _direct_form(x, w_oihw, bias, dtype):
    """The mma kernel's GEMM on the CPU: rows (pooled pixel, phase), K the
    taps k = (ky*3 + kx)*3 + ci padded to 32 (``pack_mma_weights``), N the
    channels padded to a multiple of 8; then the phase max, bias and leaky
    in fp32 and one rounding to ``dtype``."""
    b, h, w, _ = x.shape
    h2, w2 = h // 2, w // 2
    c_out = w_oihw.shape[0]
    xp = torch.nn.functional.pad(torch.from_numpy(x).to(dtype).float(),
                                 (0, 0, 1, 1, 1, 1))
    phases = []
    for py in range(2):
        for px in range(2):
            taps = torch.stack(
                [xp[:, py + ky:py + ky + h:2, px + kx:px + kx + w:2, :]
                 for ky in range(3) for kx in range(3)], dim=-2)
            taps = taps.reshape(b, h2, w2, 27)
            phases.append(torch.nn.functional.pad(taps, (0, 5)))
    a = torch.stack(phases, dim=3)                    # (B, H2, W2, 4, 32)
    wp = tis.pack_mma_weights(w_oihw.to(dtype)).float()  # (N_pad, 32)
    r = torch.matmul(a, wp.t()).amax(dim=3)[..., :c_out]
    y = r + torch.from_numpy(bias)
    y = torch.where(y > 0, y, 0.1 * y)
    return y.to(dtype).float().numpy()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("c_out", [1, 8, 13, 32])
def test_direct_form_matches_jax_xla_twin(c_out, dt):
    """The mma kernel's layout (packed weights, direct-form im2col, phase
    max) computes ``fused_conv1_pool_xla``. fp32: summation order only,
    atol 1e-5. bf16 operands: one bf16 ulp of the largest output (2**-7
    relative), since both round the fp32 result once."""
    x, w, b = _rand_case(c_out, h=18, w=34, seed=20 + c_out)
    tdt, jdt = _DTYPES[dt]
    want = np.asarray(jis.fused_conv1_pool_xla(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), compute_dtype=jdt),
        np.float32)
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = _direct_form(x, w_oihw, b, tdt)
    assert got.shape == want.shape == (2, 9, 17, c_out)
    tol = FP32_ATOL if dt == "fp32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_fused_forward_matches_unfused_fast():
    """Tiny-YOLOv2 at 64x64: forward_folded with the fused input stage
    equals the plain conv+pool path at bf16 tolerance."""
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.models import (
        fold_batchnorm, forward_folded, init_params, tiny_yolov2_voc,
    )
    spec = tiny_yolov2_voc()
    spec.net.width = spec.net.height = 64
    params = fold_batchnorm(init_params(spec, seed=0), spec)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    want = forward_folded(params, x, spec, FAST)
    got = forward_folded(params, x, spec, FAST, fuse_input_stage=True)
    assert got.shape == want.shape
    _assert_close_bf16(got.numpy(), want.numpy())
