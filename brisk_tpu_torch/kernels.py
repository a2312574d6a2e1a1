"""Hand-written CUDA kernels of the port: build, bind and launch.

Each kernel lives in `csrc/*.cu` with a plain C entry point (the
enumerator's two share their arithmetic in `csrc/enum_math.cuh`, which a
host compiler also builds for the CPU tests), is compiled
by `nvcc` for sm_90a into a shared library under `_build/` (named by the
source's content hash and flags, so an edited source rebuilds) at first
use, and is called through ctypes on PyTorch's current stream. The span
expansion is built once per s_max (its one compile-time shape,
-DBRISK_S_MAX); the other sources once each. Nothing is built or loaded
at import.

A wrapper checks device, dtype, contiguity and shapes and raises on
anything else; it raises when the launch reports a CUDA error; it adds
one to `LAUNCHES[name]` per launch. The plain PyTorch version of each
kernel sits next to its caller (the CPU path and the reference).

    expand_span          csrc/expand_span.cu   replaces the Pallas kernel
                         brisk_tpu/index/sklstore.py
                         _expand_span_jmajor_pallas; J-major or
                         row-major (LAUNCHES "expand_span_jmajor",
                         "expand_span_rowmajor")
    state_scan           csrc/state_scan.cu    replaces the lax.scan of
                         brisk_tpu/ops/enumerate.py enumerate_batch (the
                         per-position minimizer state machine); plain
                         version ops.enumerate._state_machine_torch
    rescan               csrc/rescan.cu        replaces the XLA pass
                         brisk_tpu/ops/minimizer.py
                         windowed_get_minimizer; plain version
                         ops.minimizer.windowed_get_minimizer_torch
    positions            csrc/positions.cu     replaces the XLA fusion
                         brisk_tpu/ops/minimizer.py position_pipeline
                         (the k- and m-base windows and the candidate at
                         every position); plain version
                         ops.minimizer.position_pipeline_torch
    emit                 csrc/emit.cu          replaces the XLA fusion
                         after the scan in brisk_tpu/ops/enumerate.py
                         enumerate_batch (emitted k-mer, key, bucket);
                         plain version ops.enumerate._emit_torch
    skl_rows             csrc/skl_rows.cu      replaces the XLA program
                         brisk_tpu/index/sklstore.py
                         rows_from_emissions; plain version
                         index.sklstore.rows_from_emissions_torch
    join_scan            csrc/run_scan.cu      replaces the scan after the
                         sort of the XLA program brisk_tpu/index/
                         sklstore.py _query_join_partials; plain version
                         index.sklstore._join_scan_torch
    run_totals           csrc/run_scan.cu      replaces the run totals of
                         the XLA program brisk_tpu/index/store.py
                         compact; plain version
                         index.store._run_totals_torch

The enumerator's five share their arithmetic in `csrc/enum_math.cuh` and
`csrc/flush_math.cuh`; the last two are two C entries of one library,
their arithmetic in `csrc/run_scan.cuh`.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
from typing import NamedTuple

import torch

from brisk_tpu_torch.index import store

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "_build")
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


class _Source(NamedTuple):
    path: str
    entry: str          # the C entry point (a library may have several)
    argtypes: list
    per_s_max: bool     # one library per s_max (-DBRISK_S_MAX)


_SOURCES = {
    "expand_span": _Source(os.path.join(_DIR, "csrc", "expand_span.cu"),
                           "brisk_expand_span",
                           [_PTR] * 4 + [_INT] * 8 + [_PTR], True),
    "state_scan": _Source(os.path.join(_DIR, "csrc", "state_scan.cu"),
                          "brisk_state_scan",
                          [_PTR, _PTR] + [_INT] * 4 + [_PTR], False),
    "rescan": _Source(os.path.join(_DIR, "csrc", "rescan.cu"),
                      "brisk_rescan",
                      [_PTR, _PTR, _PTR] + [_INT] * 4 + [_PTR], False),
    "positions": _Source(os.path.join(_DIR, "csrc", "positions.cu"),
                         "brisk_positions",
                         [_PTR] * 4 + [_INT] * 2 + [ctypes.c_longlong]
                         + [_INT] * 2 + [_PTR], False),
    "emit": _Source(os.path.join(_DIR, "csrc", "emit.cu"), "brisk_emit",
                    [_PTR, _PTR] + [_INT] * 6 + [_PTR], False),
    "skl_rows": _Source(os.path.join(_DIR, "csrc", "skl_rows.cu"),
                        "brisk_skl_rows",
                        [_PTR] * 4 + [_INT] * 10 + [_PTR], False),
    # the positions a skl_rows block takes at once (brisk::kRowTile)
    "skl_rows_tile": _Source(os.path.join(_DIR, "csrc", "skl_rows.cu"),
                             "brisk_skl_rows_tile", [], False),
    "join_scan": _Source(os.path.join(_DIR, "csrc", "run_scan.cu"),
                         "brisk_join_scan",
                         [_PTR] * 4 + [ctypes.c_longlong] + [_INT] * 2
                         + [_PTR], False),
    "run_totals": _Source(os.path.join(_DIR, "csrc", "run_scan.cu"),
                          "brisk_run_totals",
                          [_PTR] * 5 + [ctypes.c_longlong, _INT, _PTR],
                          False),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAYOUTS = {"jmajor": 0, "rowmajor": 1}
LAUNCHES = {"expand_span_jmajor": 0, "expand_span_rowmajor": 0,
            "state_scan": 0, "rescan": 0, "positions": 0, "emit": 0,
            "skl_rows": 0, "join_scan": 0, "run_totals": 0}
# dtypes of a MinimizerState's 7 fields (rev is bool)
_STATE_DTYPES = (torch.int64,) * 3 + (torch.bool,) + (torch.int64,) * 3
_libs = {}  # (source path, s_max or None) -> loaded library
_fns = {}   # (source path, entry, s_max or None) -> its C entry point
BUILD_LOG = {}  # library name -> nvcc output (ptxas register report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if not home:
        raise RuntimeError("nvcc not found: set CUDA_HOME")
    return os.path.join(home, "bin", "nvcc")


def _build_so(name: str, s_max) -> str:
    """Compile kernel `name`'s CUDA source (at one s_max, for the span
    expansion) into `_build/lib<source>[_s<s_max>]_<hash>.so` (once per
    content of the source and of the headers beside it, and flags);
    returns the library's path."""
    src = _SOURCES[name].path
    flags = NVCC_FLAGS + ([f"-DBRISK_S_MAX={s_max}"] if s_max else [])
    sha = hashlib.sha256(" ".join(flags).encode())
    csrc = os.path.dirname(src)
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(csrc, f) for f in headers]:
        with open(path, "rb") as fh:
            sha.update(fh.read())
    digest = sha.hexdigest()
    base = os.path.splitext(os.path.basename(src))[0]
    tag = f"{base}_s{s_max}" if s_max else base
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


def _entry(name: str, s_max=None):
    """Build (once per source content) and load kernel `name`'s library;
    returns its C entry point with its argument types set."""
    src = _SOURCES[name]
    key = (src.path, src.entry, s_max)
    if key not in _fns:
        if (src.path, s_max) not in _libs:
            _libs[src.path, s_max] = ctypes.CDLL(_build_so(name, s_max))
        fn = getattr(_libs[src.path, s_max], src.entry)
        fn.argtypes = src.argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def build(s_maxes=(8,)) -> dict:
    """Build and load every kernel library now (the span expansion at each
    s_max, the others once), one nvcc per library, all started together;
    returns the build logs. s_max is 8 at every configuration with
    m <= k - 4."""
    jobs = {}
    for name, src in _SOURCES.items():
        for s in (s_maxes if src.per_s_max else (None,)):
            jobs.setdefault((src.path, s), (name, s))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _entry(*job), jobs.values()))
    return dict(BUILD_LOG)


def _check(t: torch.Tensor, what: str, shape: tuple, device,
           dtype=torch.int32) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
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
    fn = _entry("expand_span", s_max)
    _launch("expand_span_" + layout, fn, (
        sb.data_ptr(), sm.data_ptr(), sn.data_ptr(), out.data_ptr(), R, k,
        m, b, s_max, nw, W, LAYOUTS[layout]), dev)
    return out


def expand_span_jmajor(sb: torch.Tensor, sm: torch.Tensor, sn: torch.Tensor,
                       k: int, m: int, b: int, s_max: int) -> torch.Tensor:
    """The J-major CUDA span expansion (expand_span, layout "jmajor")."""
    return expand_span(sb, sm, sn, k, m, b, s_max, layout="jmajor")


def _launch(name: str, fn, args: tuple, dev) -> None:
    """Call one C entry on `dev`'s current stream; raise on its error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def launch_delta(before: dict, after: dict) -> dict:
    """Launches of each kernel between two snapshots of LAUNCHES (the
    kernels whose count changed)."""
    return {name: n - before.get(name, 0) for name, n in after.items()
            if n != before.get(name, 0)}


def add_launches(delta: dict, times: int = 1, counts: dict = None) -> None:
    """Add `times` x `delta` (a launch_delta) to `counts` (LAUNCHES by
    default). A CUDA graph's capture calls the wrappers without launching
    anything and its replays launch without calling them, so a graph
    runner takes its capture's delta back out (times=-1) and adds it on
    every replay: LAUNCHES keeps counting the kernels run on the card."""
    counts = LAUNCHES if counts is None else counts
    for name, n in delta.items():
        counts[name] += times * n


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def state_scan(cand: tuple, rescan: tuple, state0: tuple,
               fresh: torch.Tensor, km: int, margin: int):
    """CUDA minimizer state machine (the contract of
    ops.enumerate._state_machine_torch). cand = (heavy, hash_hi,
    hash_lo, canon_lo, canon_hi, is_rc) and rescan (a MinimizerState's 7
    fields) are (B, L_buf) tensors, read at columns [margin, L_buf);
    state0 (7 fields) and fresh are (B,). Returns ([boundary, rev, pos,
    mini, h], final): (B, L_out) bool, bool, int64, int64 (lo | hi << 32)
    and int64 (hashing.pack_hash), and the 7 final-state fields (B,)."""
    if len(cand) != 6 or len(rescan) != 7 or len(state0) != 7:
        raise ValueError("state_scan: expected 6 candidate, 7 rescan and "
                         "7 state fields")
    if fresh.dim() != 1 or cand[0].dim() != 2:
        raise ValueError(f"unsupported shapes: fresh {tuple(fresh.shape)}, "
                         f"candidates {tuple(cand[0].shape)}")
    B, L_buf = cand[0].shape
    if not 0 <= margin <= L_buf or fresh.shape[0] != B:
        raise ValueError(f"unsupported shapes: fresh {tuple(fresh.shape)}, "
                         f"candidates {(B, L_buf)}, margin {margin}")
    dev = fresh.device
    row_dtypes = (torch.int64,) * 5 + (torch.bool,) + _STATE_DTYPES
    for i, (t, dt) in enumerate(zip(cand + tuple(rescan), row_dtypes)):
        _check(t, f"state_scan input {i}", (B, L_buf), dev, dt)
    for i, (t, dt) in enumerate(zip(state0, _STATE_DTYPES)):
        _check(t, f"state_scan state field {i}", (B,), dev, dt)
    _check(fresh, "fresh", (B,), dev, torch.bool)
    L_out = L_buf - margin
    rows = [torch.empty((B, L_out), dtype=dt, device=dev) for dt in (
        torch.bool, torch.bool, torch.int64, torch.int64, torch.int64)]
    final = tuple(torch.empty(B, dtype=dt, device=dev)
                  for dt in _STATE_DTYPES)
    if B == 0:
        return rows, final
    fn = _entry("state_scan")
    _launch("state_scan", fn, (
        _ptrs(cand + tuple(rescan) + tuple(state0) + (fresh,)),
        _ptrs(rows + list(final)), B, L_buf, margin, km), dev)
    return rows, final


def rescan(canon: tuple, cand_hash: tuple, scan_rev: torch.Tensor,
           kmer4: tuple, coef: torch.Tensor, k_arg: int, m: int,
           with_unique: bool = False):
    """CUDA get_minimizer rescan (the contract of
    ops.minimizer.windowed_get_minimizer_torch). canon = (lo, hi),
    cand_hash = (heavy, hi, lo) and the 4 k-mer limbs are int64 (R, L)
    tensors, scan_rev bool (R, L); coef is the (4m,) float64 decycling
    table (pyref.get_decycling(m).coef) on the same card. Returns the 7
    MinimizerState fields, (R, L) each, and with_unique also the bool
    unique-minimum flags.

    The kernel compares each candidate's hash triple as one packed int64
    (hashing.pack_hash), which orders like the triple only while heavy
    is in {0, 1, 2} and hi << 32 | lo < 2^62: what position_pipeline
    makes (a decycling class, a key masked to 2m <= 62 bits), and the
    only input the rescan receives."""
    if len(canon) != 2 or len(cand_hash) != 3 or len(kmer4) != 4:
        raise ValueError("rescan: expected 2 canonical, 3 hash and 4 "
                         "k-mer limbs")
    if scan_rev.dim() != 2 or not 1 <= m <= 31 or not m <= k_arg <= 63:
        raise ValueError(f"unsupported shapes: scan_rev "
                         f"{tuple(scan_rev.shape)}, k_arg={k_arg}, m={m}")
    R, L = scan_rev.shape
    dev = scan_rev.device
    ins = tuple(canon) + tuple(cand_hash) + (scan_rev,) + tuple(kmer4)
    dtypes = (torch.int64,) * 5 + (torch.bool,) + (torch.int64,) * 4
    for i, (t, dt) in enumerate(zip(ins, dtypes)):
        _check(t, f"rescan input {i}", (R, L), dev, dt)
    _check(coef, "coef", (4 * m,), dev, torch.float64)
    outs = [torch.empty((R, L), dtype=dt, device=dev)
            for dt in _STATE_DTYPES]
    unique = (torch.empty((R, L), dtype=torch.bool, device=dev)
              if with_unique else None)
    if R * L > 0:
        fn = _entry("rescan")
        _launch("rescan", fn, (_ptrs(ins), _ptrs(outs + [unique]),
                               coef.data_ptr(), R, L, k_arg, m), dev)
    return (tuple(outs), unique) if with_unique else tuple(outs)


def positions(codes: torch.Tensor, coef: torch.Tensor, k: int, m: int):
    """CUDA position pipeline (the contract of
    ops.minimizer.position_pipeline_torch): codes are int64 (R, L) 2-bit
    codes whose rows may be strided (codes[:, :k-1] of a wider buffer)
    but whose positions are adjacent; coef is the (4m,) float64 decycling
    table on the same card. Returns the 8 PositionArrays fields in order:
    fwd_k and rc_k (4 int64 limbs each), fwd_m, rc_m and canon_m (2
    each), cand_hash (heavy, hi, lo), cand_is_rc and scan_rev (bool), all
    (R, L) views of two buffers (17 int64 planes, 2 bool planes)."""
    if codes.dim() != 2 or not 1 <= m <= 31 or not 1 <= k <= 63:
        raise ValueError(f"unsupported shapes: codes {tuple(codes.shape)}, "
                         f"k={k}, m={m}")
    R, L = codes.shape
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"codes: expected a CUDA tensor, got {dev}")
    if codes.dtype != torch.int64:
        raise TypeError(f"codes: expected torch.int64, got {codes.dtype}")
    if R * L and (codes.stride(1) != 1 or (R > 1 and codes.stride(0) < L)):
        raise ValueError(f"codes: expected adjacent positions, got strides "
                         f"{codes.stride()}")
    _check(coef, "coef", (4 * m,), dev, torch.float64)
    out64 = torch.empty((17, R, L), dtype=torch.int64, device=dev)
    out8 = torch.empty((2, R, L), dtype=torch.bool, device=dev)
    if R * L > 0:
        _launch("positions", _entry("positions"), (
            codes.data_ptr(), out64.data_ptr(), out8.data_ptr(),
            coef.data_ptr(), R, L, codes.stride(0) if R > 1 else L, k, m),
            dev)
    o = out64.unbind(0)
    return (o[0:4], o[4:8], o[8:10], o[10:12], o[12:14], o[14:17],
            out8[0], out8[1])


def emit(rev: torch.Tensor, pos: torch.Tensor, mini: torch.Tensor,
         h: torch.Tensor, fwd_k: tuple, rc_k: tuple, k: int, m: int,
         b: int):
    """CUDA emission epilogue (the contract of ops.enumerate._emit_torch):
    rev (bool), pos, mini and h are the state machine's (B, L_out) rows;
    fwd_k and rc_k the position pipeline's 4 int64 limbs, (B, L_buf)
    each, read at columns [L_buf - L_out, L_buf). Returns mini_idx,
    mini_lo, mini_hi, hash_hi, hash_lo (B, L_out), kmer and key (4, B,
    L_out) and bucket (B, L_out), int64 views of one buffer."""
    if len(fwd_k) != 4 or len(rc_k) != 4:
        raise ValueError("emit: expected 4 fwd_k and 4 rc_k limbs")
    if (rev.dim() != 2 or fwd_k[0].dim() != 2 or not 1 <= m <= 31
            or not 0 <= b <= 15 or not m <= k <= 63):
        raise ValueError(f"unsupported shapes: rows {tuple(rev.shape)}, "
                         f"limbs {tuple(fwd_k[0].shape)}, k={k}, m={m}, "
                         f"b={b}")
    B, L_out = rev.shape
    L_buf = fwd_k[0].shape[1]
    if fwd_k[0].shape[0] != B or L_out > L_buf:
        raise ValueError(f"unsupported shapes: rows {(B, L_out)}, limbs "
                         f"{tuple(fwd_k[0].shape)}")
    dev = rev.device
    _check(rev, "rev", (B, L_out), dev, torch.bool)
    for name, t in (("pos", pos), ("mini", mini), ("h", h)):
        _check(t, name, (B, L_out), dev, torch.int64)
    for i, t in enumerate(tuple(fwd_k) + tuple(rc_k)):
        _check(t, f"k-mer limb {i}", (B, L_buf), dev, torch.int64)
    out = torch.empty((14, B, L_out), dtype=torch.int64, device=dev)
    if B * L_out > 0:
        _launch("emit", _entry("emit"), (
            _ptrs((rev, pos, mini, h) + tuple(fwd_k) + tuple(rc_k)),
            out.data_ptr(), B, L_out, L_buf, k - m, m, b), dev)
    return (out[0], out[1], out[2], out[3], out[4], out[5:9], out[9:13],
            out[13])


def skl_rows(key: torch.Tensor, bucket: torch.Tensor,
             mini_idx: torch.Tensor, use_rc: torch.Tensor,
             valid: torch.Tensor, first_valid: torch.Tensor,
             boundary: torch.Tensor, k: int, m: int, b: int, row_cap: int,
             s_max: int, nw: int, split: bool):
    """CUDA super-k-mer row assembly (the contract of
    index.sklstore.rows_from_emissions_torch): key (4, B, L), bucket and
    mini_idx (B, L) int64; use_rc, valid, first_valid, boundary (B, L)
    bool; s_max and nw the configuration's (sklstore.skl_dims), split
    whether runs longer than s_max split. Returns row_bucket, row_meta
    (B, min(L, row_cap)), row_nucs (nw, B, min(L, row_cap)) int64 views
    of one buffer, and overflow (B,) bool."""
    if (key.dim() != 3 or key.shape[0] != 4 or bucket.dim() != 2
            or not 1 <= nw <= 6 or row_cap < 0 or not 1 <= m <= k <= 63
            or not 0 <= b <= k or s_max < 1):
        raise ValueError(f"unsupported shapes: key {tuple(key.shape)}, "
                         f"bucket {tuple(bucket.shape)}, nw={nw}, "
                         f"row_cap={row_cap}, k={k}, m={m}, b={b}")
    B, L = bucket.shape
    dev = bucket.device
    _check(key, "key", (4, B, L), dev, torch.int64)
    _check(bucket, "bucket", (B, L), dev, torch.int64)
    _check(mini_idx, "mini_idx", (B, L), dev, torch.int64)
    for name, t in (("use_rc", use_rc), ("valid", valid),
                    ("first_valid", first_valid), ("boundary", boundary)):
        _check(t, name, (B, L), dev, torch.bool)
    tile = _entry("skl_rows_tile")()
    if L >= 2**31 - tile:
        raise ValueError(f"unsupported shapes: L={L} (positions and ranks "
                         f"are int32: L < 2**31 - {tile})")
    out_w = min(L, row_cap)
    out = torch.empty((2 + nw, B, out_w), dtype=torch.int64, device=dev)
    if L == 0:  # no position, no row start
        return (out[0], out[1], out[2:],
                torch.zeros(B, dtype=torch.bool, device=dev))
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    # a lane longer than one tile keeps each tile's entry values here
    carry = (torch.empty((B, -(-L // tile), 3), dtype=torch.int32,
                         device=dev) if L > tile else None)
    if B > 0:
        _launch("skl_rows", _entry("skl_rows"), (
            _ptrs(tuple(key) + (bucket, mini_idx, use_rc, valid,
                                first_valid, boundary)),
            out.data_ptr(), overflow.data_ptr(),
            None if carry is None else carry.data_ptr(), B, L, row_cap,
            out_w, k, m, b, s_max, int(split), nw), dev)
    return out[0], out[1], out[2:], overflow


def _scan_tile(n: int) -> int:
    """Slots a block of run_scan.cu takes in one tile: a power of two from
    256 (8 warps of one 32-slot group) to 4096 (16 groups a warp), the
    smallest that keeps the tiles (one a block) at 2,048 or fewer, so that
    small scans still spread over the card."""
    tile = 256
    while tile < 4096 and n > tile * 2048:
        tile *= 2
    return tile


def _scan_scratch(n: int, tile: int, dev) -> torch.Tensor:
    """run_scan.cu's scratch: the tile counter, then each tile's status,
    aggregate and prefix (the C entry zeroes the counter and statuses)."""
    return torch.empty(1 + 3 * -(-n // tile), dtype=torch.int64, device=dev)


def join_scan(words: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """CUDA run scan of the query join (the contract of
    index.sklstore._join_scan_torch): words (W, S) int64, the join's
    sorted u32 key words with the side tag in bit 0 of words[W - 1]; pay
    (S,) int64, u32 index counts on index slots and liveness on query
    slots (the kernel reads each int64's low 32 bits).
    Returns the (256,) int64 partial sums: partial p sums, over the query
    slots of [p * L, (p + 1) * L) with liveness 1 (L = ceil(S / 256)),
    their key's index count mod 256."""
    if words.dim() != 2 or not 1 <= words.shape[0] <= 6:
        raise ValueError(f"unsupported shapes: words {tuple(words.shape)}")
    W, S = words.shape
    dev = words.device
    _check(words, "words", (W, S), dev, torch.int64)
    _check(pay, "pay", (S,), dev, torch.int64)
    if S >= 2**31:
        raise ValueError(f"unsupported shapes: S={S} (S < 2**31)")
    if S == 0:
        return torch.zeros(256, dtype=torch.int64, device=dev)
    tile = _scan_tile(S)
    parts = torch.empty(256, dtype=torch.int64, device=dev)
    scratch = _scan_scratch(S, tile, dev)
    _launch("join_scan", _entry("join_scan"), (
        words.data_ptr(), pay.data_ptr(), parts.data_ptr(),
        scratch.data_ptr(), S, W, tile), dev)
    return parts


def run_totals(data: torch.Tensor, first: torch.Tensor):
    """CUDA run totals of compact (the contract of
    index.store._run_totals_torch): data (N,) int64 u32 counts in sorted
    order (the kernel reads their low 32 bits), first (N,) bool run
    starts. Returns seg_total (N,) int64, each
    run's sum mod 2^32 at its last column and 0 elsewhere, and seg_id (N,)
    int64, each column's run index (the run starts up to it, less one)."""
    if data.dim() != 1:
        raise ValueError(f"unsupported shapes: data {tuple(data.shape)}")
    N = data.shape[0]
    dev = data.device
    _check(data, "data", (N,), dev, torch.int64)
    _check(first, "first", (N,), dev, torch.bool)
    if N >= 2**31:
        raise ValueError(f"unsupported shapes: N={N} (N < 2**31)")
    out = torch.empty((2, N), dtype=torch.int64, device=dev)
    if N > 0:
        tile = _scan_tile(N)
        scratch = _scan_scratch(N, tile, dev)
        _launch("run_totals", _entry("run_totals"), (
            first.data_ptr(), data.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), scratch.data_ptr(), N, tile), dev)
    return out[0], out[1]
