"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with a
plain C interface at first use, under ``build/kernels/`` at the root of the
checkout (named by a hash of the source and the ``*.cuh`` headers, so an
edited source rebuilds), and loaded with ctypes.  Nothing here runs at import time: the CPU tests import
every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_L = ctypes.c_longlong
_SIGNATURES = {
    "spray_stack_size": [],
    # which: 0 nearest_kernel, 1 anyhit_kernel, 2 nearest_slot_kernel
    "spray_blocks_per_sm": [_I],
    # visits one block of binned_nearest_kernel (binned_anyhit_kernel)
    # walks; the nearest kernel's resident blocks
    "spray_binned_span": [],
    "spray_binned_anyhit_span": [],
    "spray_binned_blocks_per_sm": [],
    # order, n_rounds, packet, o, d, tmin, tmax, n, bounds, meta, w,
    # nn, nc, c, out_t, out_code, counters, stream
    "spray_nearest": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                      _I, _I, _I, _P, _P, _P, _P],
    # ... same up to c, then out_occ, counters, stream
    "spray_anyhit": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                     _I, _I, _I, _P, _P, _P],
    # bucket, n_dom, then as spray_nearest
    "spray_nearest_slot": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                           _I, _I, _I, _P, _P, _P, _P],
    # tri12, num_tris, o, d, tmin, tmax, n, out_t, out_prim, out_u, out_v,
    # stream
    "spray_brute_nearest": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    # tri12, num_tris, o, d, tmin, tmax, n, out_occ, tests, stream
    "spray_brute_anyhit": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    # pkt, sn, cmask, first, last, n_visits, o, d, tmin, n_packets, tri9,
    # n_super, best_t, best_code (read and updated in place), keys
    # (scratch), stream
    "spray_binned_nearest": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I,
                             _P, _P, _P, _P],
    # ... same up to tmin, then tmax, n_packets, tri9, n_super, occ (read
    # and updated in place), tests, stream
    "spray_binned_anyhit": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
                            _I, _P, _P, _P],
    # dest, m, ndev, bucket, table (scratch), send, stream
    "spray_route_slots": [_P, _I, _I, _I, _P, _P, _P],
    # pixel, sample (or NULL), sample_scalar, seed, d0, d1, d2, d3, k, n,
    # out, stream
    "spray_threefry_uniform": [_P, _P, _U, _U, _U, _U, _U, _U, _I, _L, _P,
                               _P],
}

_libs = {}


def _nvcc():
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(name):
    """Compile csrc/<name>.cu with nvcc unless the library is already built.
    Returns (library path, nvcc's stderr: its ptxas report, kept in a .log
    file beside the library); raises with nvcc's output on error."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include them
        digest.update(header.read_bytes())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stderr


def ptxas_report(log):
    """{kernel: registers, shared memory (smem), stack and spill bytes} from
    the report `nvcc -Xptxas -v` writes for each entry function."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            names = re.findall(r"[a-z_]+_kernel", m.group(1))
            name = names[-1] if names else m.group(1)
            out[name] = {"registers": None, "smem": 0, "stack": 0,
                         "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:  # the entry's own line, then one per function it calls
            for key, val in zip(("stack", "spill_stores", "spill_loads"),
                                m.groups()):
                out[name][key] += int(val)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def load(name):
    """ctypes handle of csrc/<name>.cu, building it at first use."""
    lib = _libs.get(name)
    if lib is None:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(name, fn, device, *args):
    """Call launcher `fn` of csrc/<name>.cu on `device`'s current stream
    (appended as the last argument) and raise on a refused launch."""
    import torch  # noqa: PLC0415

    lib = load(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")


def check_counter(counter, device):
    """`counter`'s address, or None: an optional (1,) int64 tensor on
    `device` that a kernel adds its work count to."""
    import torch  # noqa: PLC0415

    if counter is None:
        return None
    if (counter.dtype != torch.int64 or counter.shape != (1,)
            or counter.device != device):
        raise ValueError("counter: want a (1,) int64 tensor beside the rays")
    return counter.data_ptr()


def check_tensors(device, want):
    """Raise unless every (name, tensor, dtype, ndim) of `want` is a
    contiguous tensor of that dtype and rank on `device`."""
    for name, x, dtype, ndim in want:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, rays on {device}")
        if x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name}: want {ndim}-d {dtype}, got "
                             f"{x.dim()}-d {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
