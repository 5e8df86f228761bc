"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go to ``modelcompression_tpu_torch/_build``
(listed in ``.gitignore``), named by a hash of their source and of the
shared ``csrc/*.cuh`` headers, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built when a
module is imported: the first launch builds, or a caller (``chip_smoke.py``)
builds every kernel up front with ``build_all``, one ``nvcc`` per source,
all started together.

Every kernel is launched through one ``Kernel``, its C entry's seam: the
entry is resolved and its argument types set on the first launch, the
launch goes on PyTorch's current stream of its tensors' device, shows as a
host op named after its source under a recording profiler, raises on a
refused launch, and is counted, in total and by the kernel's width.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Sequence

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of the last build of each kernel
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source
    and of every shared header in ``csrc/`` it may include."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = library_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: str, job) -> str:
    if job is None:
        return out
    proc, tmp = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees a whole file
    return out


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all running at once. Returns ``{name: library path}``."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, *jobs[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        _LIBS[name] = lib
    return lib


class Kernel:
    """The C entry ``mc_<source>`` of ``csrc/<source>.cu`` and its launch
    counts. Every entry takes its own arguments (``args``: pointers as
    ``ctypes.c_void_p``, since ctypes would pass a bare Python int as a
    32-bit int and cut a pointer), then the device that holds its tensors
    (made current for the launch by the entry) and the stream, and returns
    a CUDA error code, 0 on success.

    ``launches`` counts every launch, ``at`` the same launches by the
    kernel's width: the input stages' and the conv epilogue's output
    channels C, the top-k kernels' segment count S."""

    def __init__(self, source: str, args: Sequence):
        self.source = source
        self._types = [*args, ctypes.c_int, ctypes.c_void_p]
        self._fn = None
        self.launches = 0
        self.at: collections.Counter = collections.Counter()

    def _resolve(self):
        fn = getattr(load(self.source), f"mc_{self.source}")
        fn.argtypes = self._types
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, width: int, device: int, *args) -> None:
        """One launch on PyTorch's current stream of CUDA device
        ``device`` (an index), counted at ``width``; under a recording
        profiler inside a host op named after the source, so that the
        trace links the kernel to it. Raises when the launch is refused,
        counting nothing."""
        fn = self._fn
        if fn is None:
            fn = self._resolve()
        stream = torch._C._cuda_getCurrentRawStream(device)
        if _profiler_enabled():
            with _RecordFunctionFast(self.source):
                err = fn(*args, device, stream)
        else:
            err = fn(*args, device, stream)
        if err != 0:
            raise RuntimeError(f"{self.source} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        self.at[width] += 1

    def reset(self) -> None:
        self.launches = 0
        self.at.clear()
