"""Hand-written CUDA kernels of the port: build, bind and launch.

Each kernel lives in `csrc/*.cu` with a plain C entry point, is compiled
by `nvcc` for sm_90a into a shared library under `_build/` (named by the
source's content hash and flags, so an edited source rebuilds) at first
use, one library per s_max (its one compile-time shape, -DBRISK_S_MAX),
and is called through ctypes on PyTorch's current stream. Nothing is
built or loaded at import.

A wrapper checks device, dtype, contiguity and shapes and raises on
anything else; it raises when the launch reports a CUDA error; it adds
one to `LAUNCHES[name]` per launch. The plain PyTorch version of each
kernel sits next to its caller (the CPU path and the reference).

    expand_span          csrc/expand_span.cu   replaces the Pallas kernel
                         brisk_tpu/index/sklstore.py
                         _expand_span_jmajor_pallas; J-major or
                         row-major (LAUNCHES "expand_span_jmajor",
                         "expand_span_rowmajor")
"""

import concurrent.futures
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

LAYOUTS = {"jmajor": 0, "rowmajor": 1}
LAUNCHES = {"expand_span_jmajor": 0, "expand_span_rowmajor": 0}
_libs = {}  # (name, s_max) -> loaded library
BUILD_LOG = {}  # library name -> nvcc output (ptxas register report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if not home:
        raise RuntimeError("nvcc not found: set CUDA_HOME")
    return os.path.join(home, "bin", "nvcc")


def _build_so(name: str, s_max: int) -> str:
    """Compile one CUDA source at one s_max into
    `_build/lib<name>_s<s_max>_<hash>.so` (once per source content and
    flags); returns the library's path."""
    src = _SOURCES[name]
    flags = NVCC_FLAGS + [f"-DBRISK_S_MAX={s_max}"]
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()
                                + " ".join(flags).encode()).hexdigest()
    tag = f"{name}_s{s_max}"
    so = os.path.join(_BUILD_DIR, f"lib{tag}_{digest[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc()] + flags + ["-o", tmp, src],
                              capture_output=True, text=True)
        BUILD_LOG[tag] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{BUILD_LOG[tag]}")
        os.replace(tmp, so)
    return so


def _library(name: str, s_max: int) -> ctypes.CDLL:
    """Build (once per source content) and load one kernel library."""
    if (name, s_max) in _libs:
        return _libs[name, s_max]
    lib = ctypes.CDLL(_build_so(name, s_max))
    fn = lib.brisk_expand_span
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _libs[name, s_max] = lib
    return lib


def build(s_maxes=(8,)) -> dict:
    """Build and load every kernel library at each s_max now, one nvcc per
    library, all started together; returns the build logs. s_max is 8 at
    every configuration with m <= k - 4."""
    jobs = [(name, s) for name in _SOURCES for s in s_maxes]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _library(*job), jobs))
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


def expand_span(sb: torch.Tensor, sm: torch.Tensor, sn: torch.Tensor,
                k: int, m: int, b: int, s_max: int,
                layout: str = "jmajor") -> torch.Tensor:
    """CUDA span expansion: int32 rows sb (R,), sm (R,), sn (nw, R) ->
    keys (W, s_max*R) int32, J-major (slot j*R + r; the contract of
    sklstore._expand_span_jmajor_torch) or row-major (slot r*s_max + j;
    sklstore._expand_span_rowmajor_torch)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}, "
                         f"got {layout!r}")
    R = sb.shape[0] if sb.dim() == 1 else -1
    nw = sn.shape[0] if sn.dim() == 2 else -1
    W = store.key_words(k, b)
    if R < 0 or not 1 <= nw <= 6 or W > 6 or not 1 <= s_max <= 8:
        raise ValueError(f"unsupported shapes: sb {tuple(sb.shape)}, "
                         f"sn {tuple(sn.shape)}, W={W}, s_max={s_max}")
    dev = sb.device
    _check(sb, "bucket", (R,), dev)
    _check(sm, "meta", (R,), dev)
    _check(sn, "nucs", (nw, R), dev)
    out = torch.empty((W, s_max * R), dtype=torch.int32, device=dev)
    if R == 0:
        return out
    fn = _library("expand_span", s_max).brisk_expand_span
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(sb.data_ptr(), sm.data_ptr(), sn.data_ptr(), out.data_ptr(),
                R, k, m, b, s_max, nw, W, LAYOUTS[layout], stream)
    if rc != 0:
        raise RuntimeError(f"expand_span ({layout}) launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["expand_span_" + layout] += 1
    return out


def expand_span_jmajor(sb: torch.Tensor, sm: torch.Tensor, sn: torch.Tensor,
                       k: int, m: int, b: int, s_max: int) -> torch.Tensor:
    """The J-major CUDA span expansion (expand_span, layout "jmajor")."""
    return expand_span(sb, sm, sn, k, m, b, s_max, layout="jmajor")
