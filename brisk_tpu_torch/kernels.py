"""Hand-written CUDA kernels of the port: build, bind and launch.

Each kernel lives in `csrc/*.cu` with a plain C entry point, is compiled
by `nvcc` for sm_90a into a shared library under `_build/` (named by the
source's content hash, so an edited source rebuilds) at first use, and is
called through ctypes on PyTorch's current stream. Nothing is built or
loaded at import.

A wrapper checks device, dtype, contiguity and shapes and raises on
anything else; it raises when the launch reports a CUDA error; it adds
one to `LAUNCHES[name]` per launch. The plain PyTorch version of each
kernel sits next to its caller (the CPU path and the reference).

    expand_span_jmajor   csrc/expand_span.cu   replaces the Pallas kernel
                         brisk_tpu/index/sklstore.py
                         _expand_span_jmajor_pallas
"""

import ctypes
import hashlib
import os
import subprocess

import torch

from brisk_tpu_torch.index import store

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "_build")
_SOURCES = {"expand_span": os.path.join(_DIR, "csrc", "expand_span.cu")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"expand_span_jmajor": 0}
_libs = {}
BUILD_LOG = {}  # name -> nvcc output of the build (ptxas register report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if not home:
        raise RuntimeError("nvcc not found: set CUDA_HOME")
    return os.path.join(home, "bin", "nvcc")


def _library(name: str) -> ctypes.CDLL:
    """Build (once per source content) and load one kernel library."""
    if name in _libs:
        return _libs[name]
    src = _SOURCES[name]
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(_BUILD_DIR, f"lib{name}_{digest[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                              capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{BUILD_LOG[name]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    fn = lib.brisk_expand_span_jmajor
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def build() -> dict:
    """Build and load every kernel library now; returns the build logs."""
    for name in _SOURCES:
        _library(name)
    return dict(BUILD_LOG)


def _check(t: torch.Tensor, what: str, shape: tuple, device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def expand_span_jmajor(sb: torch.Tensor, sm: torch.Tensor, sn: torch.Tensor,
                       k: int, m: int, b: int, s_max: int) -> torch.Tensor:
    """CUDA span expansion: int32 rows sb (R,), sm (R,), sn (nw, R) ->
    keys (W, s_max*R) int32, J-major (slot j*R + r). Same contract as
    sklstore._expand_span_jmajor_torch."""
    R = sb.shape[0] if sb.dim() == 1 else -1
    nw = sn.shape[0] if sn.dim() == 2 else -1
    W = store.key_words(k, b)
    if R < 0 or not 1 <= nw <= 6 or W > 6 or not 1 <= s_max <= 255:
        raise ValueError(f"unsupported shapes: sb {tuple(sb.shape)}, "
                         f"sn {tuple(sn.shape)}, W={W}, s_max={s_max}")
    dev = sb.device
    _check(sb, "bucket", (R,), dev)
    _check(sm, "meta", (R,), dev)
    _check(sn, "nucs", (nw, R), dev)
    out = torch.empty((W, s_max * R), dtype=torch.int32, device=dev)
    if R == 0:
        return out
    fn = _library("expand_span").brisk_expand_span_jmajor
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(sb.data_ptr(), sm.data_ptr(), sn.data_ptr(), out.data_ptr(),
                R, k, m, b, s_max, nw, W, stream)
    if rc != 0:
        raise RuntimeError(f"expand_span_jmajor launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["expand_span_jmajor"] += 1
    return out
