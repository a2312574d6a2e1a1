"""The arithmetic of the flush's CUDA kernels, on the CPU.

`brisk_tpu_torch/csrc/flush_math.cuh` holds what `positions.cu`,
`emit.cu` and `skl_rows.cu` compute per position and per lane: the k- and
m-base windows that end at a position and its candidate (canonical
m-mer, mixed key, decycling class, strand flags), the emitted k-mer with
its hashed minimizer slice and bucket, and each position's contribution
to its super-k-mer row, the row's meta and the output slot. Here g++
builds it with `tests/flush_math_host.cpp` (a shim for the CUDA
qualifiers, and the kernels' loops run sequentially) into a temporary
library, and ctypes drives it against the plain versions,
`ops.minimizer.position_pipeline_torch`, `ops.enumerate._emit_torch` and
`index.sklstore.rows_from_emissions_torch`, on inputs that the plain
pipeline makes from numpy-seeded codes. Every comparison is exact
(integer data, tolerance 0).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from brisk_tpu_torch.index import sklstore
from brisk_tpu_torch.ops import decycling
from brisk_tpu_torch.ops import enumerate as t_enum
from brisk_tpu_torch.ops import minimizer as t_min

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The header and its host entry points, built with g++ (skip
    without it)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/flush_math.cuh on the host")
    so = str(tmp_path_factory.mktemp("flush_math") / "libflush_host.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "brisk_tpu_torch", "csrc"),
         os.path.join(REPO, "tests", "flush_math_host.cpp"), "-o", so],
        check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.host_positions.argtypes = ([_PTR] * 4 + [_INT] * 2
                                   + [ctypes.c_longlong] + [_INT] * 2)
    lib.host_emit.argtypes = [_PTR, _PTR] + [_INT] * 6
    lib.host_skl_rows.argtypes = [_PTR] * 3 + [_INT] * 10
    lib.host_roll_windows.argtypes = ([_PTR, _PTR] + [_INT] * 2
                                      + [ctypes.c_longlong] + [_INT] * 3)
    lib.host_geometry.argtypes = [_PTR]
    for fn in (lib.host_positions, lib.host_emit, lib.host_skl_rows,
               lib.host_roll_windows, lib.host_geometry):
        fn.restype = ctypes.c_int
    return lib


def _geometry(lib) -> dict:
    """The kernels' compile-time runs and blocks, from the header."""
    out = (ctypes.c_int * 4)()
    assert lib.host_geometry(out) == 0
    return dict(pos_run=out[0], pos_threads=out[1], row_run=out[2],
                row_threads=out[3])


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() for t in tensors])


def _codes(shape, seed: int) -> torch.Tensor:
    """Random 2-bit codes with a poly-A run and a palindromic repeat
    (tied minimizers, long rows to split)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, shape)
    n = shape[-1]
    codes[0, 5:n - 5] = 0
    codes[1 % shape[0]] = np.resize([0, 1, 3, 2, 2, 3, 1, 0], n)
    return torch.from_numpy(codes)


def _host_positions(lib, codes, k: int, m: int) -> t_min.PositionArrays:
    R, L = codes.shape
    out64 = torch.empty((17, R, L), dtype=torch.int64)
    out8 = torch.empty((2, R, L), dtype=torch.bool)
    coef = decycling.coef_table(m, torch.device("cpu"))
    assert lib.host_positions(codes.data_ptr(), out64.data_ptr(),
                              out8.data_ptr(), coef.data_ptr(), R, L,
                              codes.stride(0), k, m) == 0
    o = out64.unbind(0)
    return t_min.PositionArrays(o[0:4], o[4:8], o[8:10], o[10:12],
                                o[12:14], o[14:17], out8[0], out8[1])


def _assert_positions_equal(got, want) -> None:
    for f, g, w in zip(t_min.PositionArrays._fields, got, want):
        for i, (a, b) in enumerate(zip(*((g, w) if isinstance(g, tuple)
                                         else ((g,), (w,))))):
            assert a.dtype == b.dtype and torch.equal(a, b), (f, i)


@pytest.mark.parametrize("name,k,m,shape", [
    ("k31-batch", 31, 11, (5, 30 + 97)),
    ("k21-batch", 21, 11, (4, 20 + 60)),
    ("k63-batch", 63, 21, (4, 62 + 75)),
    ("k63-rekey-rows-m23", 63, 23, (40, 63)),
    ("m16-one-limb-mixer", 31, 16, (3, 70)),
    ("short-rows", 45, 17, (9, 20)),
])
def test_positions_arithmetic_matches_plain_version(lib, name, k, m, shape):
    """Windows (zero-filled before a row's start, the reverse complement
    under the complement too), canonical m-mer, mixed key (m <= 16 and
    m > 16), decycling class and strand flags at every position."""
    codes = _codes(shape, seed=k * 13 + m)
    _assert_positions_equal(_host_positions(lib, codes, k, m),
                            t_min.position_pipeline_torch(codes, k, m))


@pytest.mark.parametrize("k,m", [(31, 11), (21, 11), (63, 21)])
def test_positions_arithmetic_on_the_strided_init(lib, k, m):
    """The fresh-lane init's (k-1) windows over codes[:, :k-1], read in
    place through the row stride (k-1 = 30 and m = 11, 21: the reverse
    complement's deposit below bit 0)."""
    codes = _codes((6, k - 1 + 40), seed=k)
    init = codes[:, :k - 1]
    assert init.stride(0) == k - 1 + 40
    _assert_positions_equal(_host_positions(lib, init, k - 1, m),
                            t_min.position_pipeline_torch(init, k - 1, m))


def _machine_rows(k, m, B, L_out, seed):
    """The plain pipeline, rescan and state machine over random codes:
    the position arrays and the machine's rows."""
    codes = _codes((B, k - 1 + L_out), seed)
    pa = t_min.position_pipeline_torch(codes, k, m)
    res = t_min.windowed_get_minimizer_torch(pa, pa.fwd_k, k, m)
    rng = np.random.default_rng(seed)
    fresh = torch.from_numpy(rng.random(B) < 0.5)
    rows, _ = t_enum._state_machine_torch(t_enum.zero_carry(B), pa, res,
                                          fresh, k - m, k - 1)
    return pa, rows


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (21, 11, 8), (63, 21, 14)])
def test_emit_arithmetic_matches_plain_version(lib, k, m, b):
    """The emitted k-mer, its minimizer index, the slice's mixed hash
    written over its hole, the bucket and the unpacked minimizer and hash
    at every emitting position."""
    pa, (_, rev, pos, mini, h) = _machine_rows(k, m, 6, 90, seed=k + b)
    B, L_out = rev.shape
    L_buf = pa.fwd_k[0].shape[1]
    ins = [t.contiguous() for t in (rev, pos, mini, h) + tuple(pa.fwd_k)
           + tuple(pa.rc_k)]
    out = torch.empty((14, B, L_out), dtype=torch.int64)
    assert lib.host_emit(_ptrs(ins), out.data_ptr(), B, L_out, L_buf, k - m,
                         m, b) == 0
    want = t_enum._emit_torch(rev, pos, mini, h, pa.fwd_k, pa.rc_k, k, m, b)
    got = (out[0], out[1], out[2], out[3], out[4], out[5:9], out[9:13],
           out[13])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


def _host_rows(lib, args, k, m, b, row_cap):
    key, bucket = args[0], args[1]
    _, s_max, _, nw = sklstore.skl_dims(k, m, b)
    B, L = bucket.shape
    out_w = min(L, row_cap)
    out = torch.empty((2 + nw, B, out_w), dtype=torch.int64)
    overflow = torch.empty(B, dtype=torch.bool)
    ins = [t.contiguous() for t in tuple(key) + tuple(args[1:])]
    assert lib.host_skl_rows(_ptrs(ins), out.data_ptr(), overflow.data_ptr(),
                             B, L, row_cap, out_w, k, m, b, s_max,
                             int(2 * (k - m) + 1 > s_max), nw) == 0
    return out[0], out[1], out[2:], overflow


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (21, 11, 8), (63, 21, 14)])
@pytest.mark.parametrize("row_cap", [4, 200])
def test_row_arithmetic_matches_plain_version(lib, k, m, b, row_cap):
    """Row starts (boundaries, first valid positions and the split every
    s_max positions), contributions and their segmented suffix sums,
    meta, and the slots of kept rows and of the padding, in overflowing
    lanes (row_cap 4) and in lanes with room, on ragged valid spans."""
    B, L_out = 7, 150
    em, _ = t_enum.enumerate_batch(
        _codes((B, k - 1 + L_out), seed=k), torch.ones(B, dtype=torch.bool),
        torch.from_numpy(np.array([180, 170, 150, 100, 178, 31, 175]) + k
                         - 31),
        t_enum.zero_carry(B), k, m, b)
    vs = torch.tensor([0, 3, 10, 0, 40, 0, 1])
    pos = torch.arange(L_out)[None, :]
    valid = em.valid & (pos >= vs[:, None])
    first_valid = pos == vs[:, None]
    args = (em.key, em.bucket, em.mini_idx, em.use_rc, valid, first_valid,
            em.boundary)
    want = sklstore.rows_from_emissions_torch(*args, k, m, b, row_cap)
    got = _host_rows(lib, args, k, m, b, row_cap)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    assert bool(want[3].any()) == (row_cap == 4)


# -- the redesigned kernels' loop order: rolled windows, runs, warp scans -----

def _windows(pa: t_min.PositionArrays) -> torch.Tensor:
    """fwd_k, rc_k, fwd_m and rc_m as 12 planes."""
    return torch.stack(pa.fwd_k + pa.rc_k + pa.fwd_m + pa.rc_m)


@pytest.mark.parametrize("k", [1, 21, 30, 31, 32, 33, 62, 63])
@pytest.mark.parametrize("m", [11, 16, 21, 23, 31])
def test_rolled_windows_match_plain_version(lib, k, m):
    """brisk::roll_run's windows from every start offset of a row (the
    registers warmed over the max(k, m) - 1 codes before it, fewer near
    the row's start) equal the plain version's at every position after
    it; rows of 80 codes outlast the registers' 64 (m > k included)."""
    R, L = 3, 80
    codes = _codes((R, L), seed=k * 31 + m)
    want = _windows(t_min.position_pipeline_torch(codes, k, m))
    got = torch.zeros((12, R, L), dtype=torch.int64)
    for start in range(L):
        got.zero_()
        assert lib.host_roll_windows(codes.data_ptr(), got.data_ptr(), R, L,
                                     L, k, m, start) == 0
        assert torch.equal(got[:, :, start:], want[:, :, start:]), start


@pytest.mark.parametrize("k,m", [(31, 11), (63, 21), (45, 17), (21, 23)])
@pytest.mark.parametrize("run_delta", [None, -1, 0, 1])
def test_positions_runs_cross_rows(lib, k, m, run_delta):
    """The kernel's runs of P positions over rows of length 1 (None),
    P - 1, P and P + 1 (a run enters the next row and starts from zero
    there; tiles cut rows), and over the strided init rows."""
    g = _geometry(lib)
    P = g["pos_run"]
    L = 1 if run_delta is None else P + run_delta
    R = 3 * g["pos_threads"] * P // L // 2 + 5  # a tile and a half
    codes = _codes((R, L + 40), seed=k + L)
    rows = codes[:, :L].contiguous()
    _assert_positions_equal(_host_positions(lib, rows, k, m),
                            t_min.position_pipeline_torch(rows, k, m))
    init = codes[:, :L]
    _assert_positions_equal(_host_positions(lib, init, k, m),
                            t_min.position_pipeline_torch(init, k, m))


def _row_lanes(k, m, b, L, seed):
    """rows_from_emissions' inputs over lanes of L positions: one valid
    throughout (long runs to split), one from L // 3 with a hole, one
    all invalid, one valid at its last position only, one whose valid
    span ends early, one with random holes."""
    B = 6
    rng = np.random.default_rng(seed)
    em, _ = t_enum.enumerate_batch(
        _codes((B, k - 1 + L), seed=seed), torch.ones(B, dtype=torch.bool),
        torch.full((B,), k - 1 + L), t_enum.zero_carry(B), k, m, b)
    pos = torch.arange(L)
    vs = torch.tensor([0, L // 3, L, L - 1, 0, 0])
    ve = torch.tensor([L, L, L, L, max(1, L // 2), L])
    valid = em.valid & (pos >= vs[:, None]) & (pos < ve[:, None])
    valid[1, L // 2: L // 2 + 3] = False
    valid[5] &= torch.from_numpy(rng.random(L) < 0.9)
    first_valid = pos == vs[:, None]
    return (em.key, em.bucket, em.mini_idx, em.use_rc, valid, first_valid,
            em.boundary)


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14)])
@pytest.mark.parametrize("L", [1, 255, 256, 257, 600, 1100])
@pytest.mark.parametrize("cap", ["4", "L"])
def test_row_scans_match_plain_version(lib, k, m, b, L, cap):
    """The kernel's order (runs of kRowRun, Kogge-Stone warp scans, the
    warps' totals, tiles walked forward then backward past one tile) and
    the segmented u32 suffix sum of the row words give the plain
    version's int64 suffix differences, slots and overflow exactly: split
    runs (2(k - m) + 1 > s_max at both), holes, overflowing lanes
    (row_cap 4), all-invalid lanes, row_cap = L."""
    row_cap = 4 if cap == "4" else L
    args = _row_lanes(k, m, b, L, seed=L + k)
    want = sklstore.rows_from_emissions_torch(*args, k, m, b, row_cap)
    got = _host_rows(lib, args, k, m, b, row_cap)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    if L >= 256 and row_cap == 4:
        assert bool(want[3].any())


def test_row_tile_comes_from_the_kernel_source(lib, monkeypatch):
    """The tile past which the skl_rows wrapper hands the kernel a scratch
    is the source's own: skl_rows.cu returns its block's tile (the
    header's kRowTile, runs x threads) from the C entry
    brisk_skl_rows_tile, kernels keeps no copy of it, and the wrapper
    sizes its scratch from what that entry returns."""
    from brisk_tpu_torch import kernels
    g = _geometry(lib)
    entry = kernels._SOURCES["skl_rows_tile"]
    assert entry.path == kernels._SOURCES["skl_rows"].path
    assert entry.entry == "brisk_skl_rows_tile" and entry.argtypes == []
    with open(entry.path) as fh:
        text = fh.read()
    assert "constexpr int kTile = brisk::kRowTile;" in text
    assert 'extern "C" int brisk_skl_rows_tile() { return kTile; }' in text
    with open(os.path.join(REPO, "brisk_tpu_torch", "csrc",
                           "flush_math.cuh")) as fh:
        assert "constexpr int kRowTile = kRowThreads * kRowRun;" in fh.read()
    assert g["row_run"] * g["row_threads"] == 512
    assert not hasattr(kernels, "ROW_TILE")
    # the wrapper on host tensors with the checks and the launch stubbed:
    # a scratch exactly when the lane is longer than the entry's tile
    launched = []
    monkeypatch.setattr(kernels, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "_launch",
                        lambda name, fn, args, dev: launched.append(args))
    k, m, b = 31, 11, 8
    args = _row_lanes(k, m, b, 300, seed=1)
    _, s_max, _, nw = sklstore.skl_dims(k, m, b)
    for tile, scratch in ((299, True), (300, False), (512, False)):
        monkeypatch.setattr(
            kernels, "_entry",
            lambda name, s_max=None, tile=tile: (lambda *a: tile))
        kernels.skl_rows(*args, k, m, b, 64, s_max, nw, True)
        assert (launched[-1][3] is not None) == scratch, tile
