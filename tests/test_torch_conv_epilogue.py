"""The port's conv epilogue (modelcompression_tpu_torch/ops/
conv_epilogue.py) on the CPU: the plain version against the eager chain in
float64 and in bf16, the kernel wrapper's checks, the launch's count and
its host op under a profiler (the library replaced by a stub), the
upsample's channels-last output that keeps every conv after it on the
kernel, and the folded forward's dispatch, which must leave every CPU and
BITMATCH forward on the eager chain, bit for bit. The kernel itself is held against
the plain version on the card in tests/test_torch_cuda_kernels.py.

Tolerances. Against float64: the plain version computes in fp32 (relative
error ~1e-6) and rounds once, so in bf16 it lies within half a bf16 ulp
(2^-8 of the magnitude) plus that slack; in fp32 within 1e-5 relative, and
an absolute 1e-38 where exp(v) is subnormal in fp32 (v < -87). Against the
eager bf16 chain, which rounds after the bias cast, the add and each of
mish's three passes: 2 bf16 ulps of the largest magnitude."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.core.precision import BITMATCH, FAST
from modelcompression_tpu_torch.data.fixtures import tiny_yolo4_cfg
from modelcompression_tpu_torch.models import darknet
from modelcompression_tpu_torch.models.cfg import ConvLayer, parse_cfg
from modelcompression_tpu_torch.ops import _build
from modelcompression_tpu_torch.ops import conv_epilogue as ce

KINDS = ("linear", "leaky", "mish")
MISH_EDGES = (-100.0, -88.0, -20.0, -1.0, -0.5, 0.0, 0.5, 1.0, 19.5, 20.0,
              21.0, 50.0, 88.0)
BF16_MIN_SUBNORMAL = 2.0 ** -133


def _act64(v: torch.Tensor, kind: str) -> torch.Tensor:
    """The eager chain's activation in float64."""
    if kind == "leaky":
        return F.leaky_relu(v, 0.1)
    if kind == "mish":
        return v * torch.tanh(F.softplus(v))
    return v


def _case(c, m, seed, scale=4.0):
    """A (1, C, 1, M) channels-last bf16 conv output and an fp32 bias."""
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.normal(0, scale, (1, m, 1, c))
                         .astype(np.float32)).to(torch.bfloat16)
    y = y.permute(0, 3, 1, 2)  # NHWC storage == channels-last NCHW
    b = torch.from_numpy(rng.normal(0, 1, (c,)).astype(np.float32))
    return y, b


def _assert_half_ulp(got: torch.Tensor, ref: torch.Tensor) -> None:
    got, ref = got.double(), ref.double()
    tol = (2.0 ** -8 + 2.0 ** -16) * ref.abs() + BF16_MIN_SUBNORMAL
    bad = (got - ref).abs() > tol
    assert not bad.any(), (got[bad][:5], ref[bad][:5])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_mish_matches_float64_at_edges(dtype):
    """Around the cut-off (v = 20: the kernel's e * e stays finite), far
    below it (exp(v) subnormal in fp32 at v < -87) and far above."""
    v = torch.tensor(MISH_EDGES, dtype=torch.float64)
    y = v.to(dtype).reshape(1, 1, 1, -1)
    got = ce.bias_act_plain(y, torch.zeros(1), "mish").reshape(-1)
    assert got.dtype == dtype
    ref = _act64(v, "mish")
    if dtype == torch.bfloat16:
        _assert_half_ulp(got, ref)
    else:
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-38)
    assert torch.isfinite(got).all()
    # above the cut-off mish is v itself
    assert (got[v > 20] == y.reshape(-1)[v > 20]).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c", [8, 32, 75, 1024])
def test_plain_matches_float64_chain(kind, c):
    y, b = _case(c, 257, seed=c)
    got = ce.bias_act_plain(y, b, kind)
    assert got.dtype == torch.bfloat16 and got.shape == y.shape
    _assert_half_ulp(got, _act64(y.double() + b.double()[None, :, None, None],
                                 kind))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c", [8, 75])
def test_plain_matches_eager_bf16_chain(kind, c):
    """The bf16 forward's eager chain before the kernel (bias cast, add,
    activation passes), within 2 bf16 ulps of the largest magnitude."""
    y, b = _case(c, 513, seed=10 + c)
    got = ce.bias_act_plain(y, b, kind).float()
    eager = darknet._activate(y + darknet._per_channel(b, y.dtype),
                              kind).float()
    top = eager.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (got - eager).abs().max().item() <= 2 * ulp


def _stub_library(monkeypatch, err=0):
    """The kernel's C entry, as the seam's loader finds it, and the stream
    lookup replaced on the CPU: the entry records its arguments and
    returns ``err``."""
    calls = []

    def entry(*args):
        calls.append(args)
        return err
    monkeypatch.setattr(ce.KERNEL, "_fn", None)
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        **{f"mc_{name}": entry}))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    return calls


@pytest.mark.parametrize("profiled", [False, True])
def test_launch_counts_and_marks_under_a_profiler(monkeypatch, profiled):
    """One launch: the entry called once with y's elements, C and the
    activation, ``launches`` and ``at[C]`` up by one, y returned;
    under a recording profiler inside one ``conv_epilogue`` host op, and
    with none outside."""
    from torch.profiler import ProfilerActivity, profile
    calls = _stub_library(monkeypatch)
    y, b = _case(24, 10, seed=4)
    n0, at0 = ce.KERNEL.launches, ce.KERNEL.at[24]
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = ce.launch(y, b, "mish")
        names = [e.name for e in prof.events()]
        assert names.count("conv_epilogue") == 1
    else:
        out = ce.launch(y, b, "mish")
    assert out is y
    assert [c[2:5] for c in calls] == [(y.numel(), 24, ce.ACTIVATIONS["mish"])]
    assert ce.KERNEL.launches == n0 + 1
    assert ce.KERNEL.at[24] == at0 + 1


def test_refused_launch_raises_uncounted(monkeypatch):
    _stub_library(monkeypatch, err=98)
    y, b = _case(8, 4, seed=5)
    n0 = ce.KERNEL.launches
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        ce.launch(y, b, "leaky")
    assert ce.KERNEL.launches == n0


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("y, bias, kind, msg", [
    (_cl((1, 8, 2, 2)), torch.zeros(8), "logistic", "takes"),
    (_cl((1, 8, 2, 2), torch.float32), torch.zeros(8), "mish", "bf16"),
    (_cl((1, 16, 2, 2))[:, ::2], torch.zeros(8), "mish", "channels-last"),
    (torch.zeros((1, 8, 3, 2), dtype=torch.bfloat16).transpose(2, 3),
     torch.zeros(8), "mish", "channels-last"),
    (torch.zeros((1, 8, 3, 2), dtype=torch.bfloat16), torch.zeros(8),
     "mish", "channels-last"),
    (torch.zeros((8, 4), dtype=torch.bfloat16), torch.zeros(4), "leaky",
     "channels-last"),
    (_cl((1, 8, 2, 2)), torch.zeros(8, dtype=torch.bfloat16), "leaky",
     "fp32"),
    (_cl((1, 8, 2, 2)), torch.zeros(7), "linear", r"\(8,\)"),
    (_cl((1, 8, 2, 2)), torch.zeros(16)[::2], "linear", "contiguous"),
    (_cl((1, 8, 2, 2)), torch.zeros(8), "mish", "CUDA tensor"),
])
def test_kernel_wrapper_rejects(monkeypatch, y, bias, kind, msg):
    """Every input the kernel does not take raises before the library is
    loaded and before any launch is counted."""
    def no_build(name):
        raise AssertionError("the wrapper reached the library")
    monkeypatch.setattr(ce.KERNEL, "_fn", None)
    monkeypatch.setattr(_build, "load", no_build)
    n0, at0 = ce.KERNEL.launches, dict(ce.KERNEL.at)
    with pytest.raises(ValueError, match=msg):
        ce.bias_act_cuda(y, bias, kind)
    assert ce.KERNEL.launches == n0
    assert dict(ce.KERNEL.at) == at0


@pytest.mark.parametrize("stride", [2, 3])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_upsample_writes_channels_last(layout, stride):
    """``upsample_nearest`` gives out[i, j] = in[i // s, j // s] in
    channels-last storage from either layout, so the concatenation and
    the convs after it stay channels-last and take the kernel."""
    x = torch.arange(2 * 5 * 3 * 4, dtype=torch.float32).reshape(2, 5, 3, 4)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    got = darknet.upsample_nearest(x, stride)
    want = x.repeat_interleave(stride, dim=2).repeat_interleave(stride,
                                                                dim=3)
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_takes_refuses_cpu_tensors(dtype, grad):
    y = _cl((2, 8, 3, 3), dtype).requires_grad_(grad)
    assert not ce.takes(y, "mish")


def _spec_params():
    spec = parse_cfg(tiny_yolo4_cfg(num_classes=3))
    params = darknet.init_params(spec, seed=0)
    gen = torch.Generator().manual_seed(1)
    for p in params.values():  # BN statistics and biases away from 0/1
        for k in ("beta", "mean", "bias"):
            if k in p:
                p[k] = torch.randn(p[k].shape, generator=gen) * 0.5
        if "var" in p:
            p["var"] = torch.rand(p["var"].shape, generator=gen) + 0.5
    x = torch.rand((2, spec.net.height, spec.net.width, 3), generator=gen)
    return spec, params, x


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("precision", [FAST, BITMATCH],
                         ids=["fast", "bitmatch"])
def test_cpu_forward_never_reaches_kernel(monkeypatch, precision, folded):
    """A CPU FAST or BITMATCH forward consults the dispatch once a conv
    (folded) or never (unfolded), is refused every time, launches nothing,
    and equals the eager chain bit for bit."""
    spec, params, x = _spec_params()
    n_convs = sum(isinstance(l, ConvLayer) for l in spec.layers)
    kinds = {l.activation for l in spec.layers if isinstance(l, ConvLayer)}
    assert kinds == set(KINDS)  # the fixture has mish, leaky and linear
    run_params = darknet.fold_batchnorm(params, spec) if folded else params
    fwd = darknet.forward_folded if folded else darknet.forward

    def run():
        with torch.inference_mode():
            return fwd(run_params, x, spec, precision)

    answers = []
    real_takes = ce.takes

    def spy(y, kind):
        answers.append(real_takes(y, kind))
        return answers[-1]

    def no_kernel(*a):
        raise AssertionError("a CPU forward reached the kernel")

    monkeypatch.setattr(ce, "bias_act_cuda", no_kernel)
    monkeypatch.setattr(ce, "launch", no_kernel)
    monkeypatch.setattr(ce, "takes", spy)
    got = run()
    assert answers == ([False] * n_convs if folded else [])
    monkeypatch.setattr(ce, "takes", lambda y, kind: False)
    eager = run()
    assert len(got) == len(eager) == 2
    for g, e in zip(got, eager):
        assert g.dtype == e.dtype and torch.equal(g, e)


def test_cpu_forward_leaves_launch_count():
    spec, params, x = _spec_params()
    n0, at0 = ce.KERNEL.launches, dict(ce.KERNEL.at)
    with torch.inference_mode():
        darknet.forward_folded(darknet.fold_batchnorm(params, spec), x, spec,
                               FAST)
    assert ce.KERNEL.launches == n0
    assert dict(ce.KERNEL.at) == at0
