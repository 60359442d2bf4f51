"""Native (C++) host build loops, loaded with ctypes, with numpy fallbacks.

Counterpart of ``spray_tpu/native``.  ``builder.cpp`` is compiled with g++
at first use into ``build/native/`` at the root of the checkout, never
beside the source.  The library's name carries a hash of the source and
the flags, so an edited source rebuilds; g++ writes a temporary file of its
own process, which ``os.replace`` puts in place, so a process never loads a
half-written library that another is still writing.  ``-ffp-contract=off``
keeps the compiler from fusing multiply-adds, so every host rounds as
x86-64 does and the numpy fallback
(``spray_tpu_torch.kernels.cluster_bvh.tri_transforms``) equals it bit for
bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_loaded = {}  # "lib": the library or None once get_lib has tried


def build(build_dir=BUILD_DIR):
    """Compile builder.cpp into `build_dir` unless it is built already.
    Returns the library's path; raises on a compiler error."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    lib = Path(build_dir) / f"libspray_native_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, lib)
    return lib


def load(build_dir=BUILD_DIR):
    """Build (if needed) and load the library with its argument types."""
    lib = ctypes.CDLL(str(build(build_dir)))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.spray_morton_order.argtypes = [f32p, f32p, ctypes.c_int64, i64p]
    lib.spray_morton_order.restype = None
    lib.spray_tri_transforms.argtypes = [f32p, f32p, f32p, ctypes.c_int64, f32p]
    lib.spray_tri_transforms.restype = None
    return lib


def get_lib():
    """The loaded native library, or None when it cannot be built here (no
    g++).  Tried once a process."""
    with _lock:
        if "lib" not in _loaded:
            try:
                _loaded["lib"] = load()
            except (OSError, subprocess.SubprocessError):
                _loaded["lib"] = None
        return _loaded["lib"]


def morton_order(tlo, thi):
    """Native Morton ordering; returns (n,) int64 or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tlo = np.ascontiguousarray(tlo, np.float32)
    thi = np.ascontiguousarray(thi, np.float32)
    n = len(tlo)
    out = np.empty(n, np.int64)
    lib.spray_morton_order(tlo, thi, n, out)
    return out


def tri_transforms(v0, e1, e2):
    """Native Woop transforms; returns (n,4,3) f32 or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    n = len(v0)
    out = np.empty((n, 4, 3), np.float32)
    lib.spray_tri_transforms(v0, e1, e2, n, out)
    return out
