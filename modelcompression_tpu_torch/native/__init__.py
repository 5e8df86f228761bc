"""Native (C++) host-side code of the port: serial codecs that numpy cannot
vectorize. One translation unit, ``huffcodec.cpp`` (the canonical-Huffman
bitstream codec of the packed artifacts, a copy of the JAX package's).

The shared library is built at first use with ``g++ -O3 -shared -fPIC``
into ``modelcompression_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, and loaded with ctypes (a plain
``extern "C"`` interface). Loading is best effort, as in the JAX package:
``load_huffcodec`` returns None when there is no compiler or the build
fails, and callers fall back to the pure-Python decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "huffcodec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_CACHE: dict = {}


def library_path() -> str:
    """Where ``huffcodec.cpp`` builds to, named by a hash of the source."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libhuffcodec-{digest}.so")


def _build(so_path: str) -> bool:
    # build to a unique temporary name, then rename: a concurrent process
    # never sees a half-written library
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
             SRC], capture_output=True, timeout=120)
        if r.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.huff_decode.restype = ctypes.c_int32
    lib.huff_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int32,
                                u16p, ctypes.c_int64]
    lib.huff_encode.restype = ctypes.c_int64
    lib.huff_encode.argtypes = [u16p, ctypes.c_int64, u64p, u8p,
                                ctypes.c_int32, u8p, ctypes.c_int64]
    return lib


def load_huffcodec(rebuild: bool = False) -> Optional[ctypes.CDLL]:
    """The huffcodec library, built if needed, or None when it can be
    neither loaded nor built."""
    if "lib" in _CACHE and not rebuild:
        return _CACHE["lib"]
    so = library_path()
    lib = None
    if (rebuild or not os.path.exists(so)) and not _build(so):
        so = None
    if so is not None:
        try:
            lib = _bind(ctypes.CDLL(so))
        except OSError:
            lib = None
    _CACHE["lib"] = lib
    return lib
