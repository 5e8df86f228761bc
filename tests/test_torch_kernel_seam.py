"""The launch seam of the port's hand-written kernels
(modelcompression_tpu_torch/ops/_build.Kernel) on the CPU, with a fake C
entry in place of a built library and a fake stream lookup: the entry's
argument types set once, the arguments passed in order with the device and
the stream last, one launch counted at its width, a host op named after the
source under a recording profiler, and a refused launch raised uncounted.
The kernels behind the seam are launched on the card in
tests/test_torch_cuda_kernels.py."""

import ctypes
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modelcompression_tpu_torch import ops
from modelcompression_tpu_torch.ops import _build

SOURCE = "fake_kernel"
ARGS = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int)
STREAM = 0x5EA


class FakeEntry:
    """A C entry that records its calls and every assignment of its
    argument types, and returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []
        self.argtypes_set = []
        self.restype = None

    @property
    def argtypes(self):
        return self.argtypes_set[-1]

    @argtypes.setter
    def argtypes(self, types):
        self.argtypes_set.append(list(types))

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def seam(monkeypatch):
    """A fresh kernel whose library is ``FakeEntry`` and whose stream
    lookup answers ``STREAM`` plus the device index; the libraries loaded
    and the devices asked for are recorded."""
    entry, loaded, asked = FakeEntry(), [], []

    def load(name):
        loaded.append(name)
        return type("Library", (), {f"mc_{name}": entry})

    def stream(device):
        asked.append(device)
        return STREAM + device

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", stream,
                        raising=False)
    return _build.Kernel(SOURCE, ARGS), entry, loaded, asked


def test_argtypes_set_once_over_two_launches(seam):
    kernel, entry, loaded, _ = seam
    kernel.launch(8, 0, 1, 2, 3)
    kernel.launch(8, 0, 4, 5, 6)
    assert loaded == [SOURCE]
    assert entry.argtypes_set == [[*ARGS, ctypes.c_int, ctypes.c_void_p]]
    assert entry.restype is ctypes.c_int


@pytest.mark.parametrize("device", [0, 3])
def test_arguments_in_order_with_device_and_stream_last(seam, device):
    kernel, entry, _, asked = seam
    kernel.launch(16, device, 0xA0, 7, 9)
    assert entry.calls == [(0xA0, 7, 9, device, STREAM + device)]
    assert asked == [device]


def test_one_launch_counted_at_its_width(seam):
    kernel, _, _, _ = seam
    kernel.launch(24, 0, 1, 2, 3)
    kernel.launch(24, 0, 1, 2, 3)
    kernel.launch(2, 0, 1, 2, 3)
    assert kernel.launches == 3
    assert dict(kernel.at) == {24: 2, 2: 1}
    kernel.reset()
    assert kernel.launches == 0 and dict(kernel.at) == {}


@pytest.mark.parametrize("profiled", [False, True])
def test_host_op_named_after_source_under_profiler(seam, profiled):
    """Under a recording profiler the launch runs inside one host op named
    after the source; outside one it records nothing."""
    kernel, entry, _, _ = seam
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if profiled:
            kernel.launch(8, 0, 1, 2, 3)
    if not profiled:
        kernel.launch(8, 0, 1, 2, 3)
    names = [e.name for e in prof.events()]
    assert names.count(SOURCE) == int(profiled)
    assert len(entry.calls) == 1


def test_refused_launch_raises_and_counts_nothing(seam):
    kernel, entry, _, _ = seam
    entry.err = 700
    with pytest.raises(RuntimeError,
                       match=f"{SOURCE} kernel launch failed: CUDA error 700"):
        kernel.launch(8, 0, 1, 2, 3)
    assert kernel.launches == 0 and dict(kernel.at) == {}


def test_registry_holds_every_csrc_kernel_once():
    """``ops.KERNELS`` holds one seam for each ``csrc/*.cu`` source."""
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith(".cu"))
    assert sorted(k.source for k in ops.KERNELS) == sources
    assert all(isinstance(k, _build.Kernel) for k in ops.KERNELS)
