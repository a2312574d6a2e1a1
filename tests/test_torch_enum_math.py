"""The arithmetic of the enumerator's CUDA kernels, on the CPU.

`brisk_tpu_torch/csrc/enum_math.cuh` holds what `state_scan.cu` and
`rescan.cu` compute (the packed hash and minimizer, the state machine's
step, the get_minimizer fold, the truncated offsets' canonical form, key
and decycling class, the constant candidate of offsets >= 32). Here g++
builds it with `tests/enum_math_host.cpp` (a shim for the CUDA
qualifiers and intrinsics, and the kernels' loops run sequentially) into
a temporary library, and ctypes drives it against the plain versions,
`ops.enumerate._state_machine_torch` and
`ops.minimizer.windowed_get_minimizer_torch`, on inputs that
`position_pipeline` makes from numpy-seeded codes. Every comparison is
exact (integer data, tolerance 0). Also: the packed hash compare orders
exactly as `hashing.hash_lt` / `hash_eq` on every pipeline-made triple,
the invariant under which the rescan compares packed hashes.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from brisk_tpu_torch.ops import decycling, hashing
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
        pytest.skip("needs g++ to build csrc/enum_math.cuh on the host")
    so = str(tmp_path_factory.mktemp("enum_math") / "libenum_math_host.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "brisk_tpu_torch", "csrc"),
         os.path.join(REPO, "tests", "enum_math_host.cpp"), "-o", so],
        check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.host_rescan.argtypes = [_PTR, _PTR, _PTR] + [_INT] * 4
    lib.host_state_scan.argtypes = [_PTR, _PTR] + [_INT] * 4
    lib.host_pack_hash.argtypes = [ctypes.c_int64] + [_PTR] * 4
    for fn in (lib.host_rescan, lib.host_state_scan):
        fn.restype = ctypes.c_int
    lib.host_pack_hash.restype = None
    return lib


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _codes(shape, seed: int, ties: bool = False) -> torch.Tensor:
    """Random 2-bit codes; with `ties`, low-entropy rows (poly-A, period
    2, 4 and 8 palindromic repeats) whose m-mer hashes tie across the
    window."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, shape)
    if ties:
        n = shape[-1]
        codes[0, :] = 0
        codes[1, :] = np.resize([0, 1], n)
        codes[2, :] = np.resize([0, 1, 3, 2], n)
        codes[3, 3:n - 3] = np.resize([0, 1, 3, 2, 2, 3, 1, 0], n - 6)
    return torch.from_numpy(codes)


def _host_rescan(lib, pa, k_arg: int, m: int, with_unique: bool):
    """rescan.cu's loops with the header's arithmetic, on the host."""
    ins = [t.contiguous() for t in (tuple(pa.canon_m) + tuple(pa.cand_hash)
                                    + (pa.scan_rev,) + tuple(pa.fwd_k))]
    R, L = pa.scan_rev.shape
    outs = [torch.empty((R, L), dtype=torch.bool if i == 3 else torch.int64)
            for i in range(7)]
    unique = torch.empty((R, L), dtype=torch.bool) if with_unique else None
    coef = decycling.coef_table(m, torch.device("cpu"))
    assert lib.host_rescan(_ptrs(ins), _ptrs(outs + [unique]),
                           coef.data_ptr(), R, L, k_arg, m) == 0
    return outs, unique


@pytest.mark.parametrize("name,k_arg,m,shape,with_unique,ties", [
    ("k31-windowed-batch", 31, 11, (6, 30 + 97), True, False),
    ("k31-windowed-ties", 31, 11, (6, 30 + 90), True, True),
    ("k31-fresh-init", 30, 11, (7, 30), False, False),
    ("k31-rekey-rows", 31, 11, (300, 31), False, False),
    ("k63-streaming-batch", 63, 21, (4, 62 + 75), False, False),
    ("k63-streaming-ties", 63, 21, (6, 62 + 90), False, True),
    ("k63-fresh-init", 62, 21, (7, 62), False, False),
    ("k63-rekey-rows", 63, 21, (300, 63), False, False),
    ("k63-rekey-rows-reallocated", 63, 23, (300, 63), False, False),
    ("k45-short-truncation", 45, 21, (5, 44 + 40), False, True),
])
def test_rescan_arithmetic_matches_plain_version(lib, name, k_arg, m, shape,
                                                 with_unique, ties):
    """The fold (clean offsets from packed neighbours, zero-filled before
    a row's start), the truncated offsets (the canonical form from one
    reverse complement of the 32-base word, the mixed key, the unrolled
    decycling sums) and the constant candidate of offsets >= 32 give
    every MinimizerState field and the unique flags of the plain
    version."""
    pa = t_min.position_pipeline(_codes(shape, seed=k_arg * 7 + shape[0],
                                        ties=ties), k_arg, m)
    outs, unique = _host_rescan(lib, pa, k_arg, m, with_unique)
    want = t_min.windowed_get_minimizer_torch(pa, pa.fwd_k, k_arg, m,
                                              with_unique)
    if with_unique:
        assert torch.equal(unique, want[1])
        if ties:
            assert int((~unique).sum()) > 100  # the tie rules decide
        want = want[0]
    for f, g, w in zip(t_min.MinimizerState._fields, outs, want):
        assert g.dtype == w.dtype and torch.equal(g, w), f


def _machine_inputs(B, L_buf, k, m, seed, carry):
    """Position arrays, the plain rescan, an initial state (the init of
    fresh lanes, or a random carry whose heavy 3-7 overflows the packed
    hash) and fresh flags."""
    codes = _codes((B, L_buf), seed, ties=B >= 4)
    pa = t_min.position_pipeline(codes, k, m)
    res = t_min.windowed_get_minimizer_torch(pa, pa.fwd_k, k, m)
    rng = np.random.default_rng(seed + 1)
    fresh = torch.from_numpy(rng.random(B) < 0.5)
    if carry == "random":
        state0 = [torch.from_numpy(rng.integers(0, 8, B)) for _ in range(7)]
        state0[3] = state0[3] % 2 == 0
        state0[4] = torch.from_numpy(rng.integers(3, 8, B))
        state0 = t_min.MinimizerState(*state0)
    else:
        margin = k - 1
        pi = t_min.position_pipeline(codes[:, :margin], k - 1, m)
        init = t_min.windowed_get_minimizer_torch(pi, pi.fwd_k, k - 1, m)
        state0 = t_min.MinimizerState(*(x[:, -1].contiguous()
                                        for x in init))
    return pa, res, state0, fresh


@pytest.mark.parametrize("k,m,B,L_out,carry", [
    (31, 11, 9, 70, "init"),      # the insert's lanes, tie-heavy rows
    (31, 11, 5, 1, "random"),     # one position
    (63, 21, 6, 90, "random"),    # a carry in, heavy 3-7
    (63, 21, 7, 40, "init"),
])
def test_scan_step_matches_plain_version(lib, k, m, B, L_out, carry):
    """The step over every lane's positions, the packing of its inputs,
    the fresh-lane suppression and the final state's unpacking give the
    plain version's outputs, also where the packed hash wraps."""
    margin = k - 1
    pa, res, state0, fresh = _machine_inputs(B, margin + L_out, k, m,
                                             seed=B + L_out, carry=carry)
    cand = tuple(pa.cand_hash) + tuple(pa.canon_m) + (pa.cand_is_rc,)
    ins = [t.contiguous() for t in cand + tuple(res) + tuple(state0)
           + (fresh,)]
    rows = [torch.empty((B, L_out), dtype=dt) for dt in (
        torch.bool, torch.bool, torch.int64, torch.int64, torch.int64)]
    final = [torch.empty(B, dtype=t.dtype) for t in state0]
    assert lib.host_state_scan(_ptrs(ins), _ptrs(rows + final), B,
                               margin + L_out, margin, k - m) == 0
    want_rows, want_final = t_enum._state_machine_torch(
        state0, pa, res, fresh, k - m, margin)
    for g, w in zip(rows + final, list(want_rows) + list(want_final)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if carry == "random":  # the wrap was exercised
        assert bool((state0.heavy > 2).any())


@pytest.mark.parametrize("k,m,ties", [(31, 11, False), (31, 11, True),
                                      (63, 21, False), (63, 23, True)])
def test_packed_compare_orders_as_the_triples(lib, k, m, ties):
    """On pipeline-made hash triples (heavy in {0, 1, 2}, key < 2^62),
    the header's pack_hash compared signed gives hash_lt and hash_eq of
    every pair of neighbours, of every pair with the zero-filled
    candidate, and of a shuffled pairing."""
    pa = t_min.position_pipeline(_codes((8, 200), seed=k + m, ties=ties),
                                 k, m)
    heavy, hi, lo = (t.reshape(-1).contiguous() for t in pa.cand_hash)
    assert int(heavy.min()) >= 0 and int(heavy.max()) <= 2
    assert int(hi.max()) < 2 ** 30 and int(lo.max()) < 2 ** 32
    zero = torch.zeros(1, dtype=torch.int64)
    heavy, hi, lo = (torch.cat([t, zero]) for t in (heavy, hi, lo))
    n = heavy.numel()
    packed = torch.empty(n, dtype=torch.int64)
    lib.host_pack_hash(n, heavy.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                       packed.data_ptr())
    assert torch.equal(packed, hashing.pack_hash(heavy, hi, lo))
    perm = torch.from_numpy(np.random.default_rng(k).permutation(n))
    for a, b in ((torch.arange(n - 1), torch.arange(1, n)),
                 (torch.arange(n), torch.full((n,), n - 1)),
                 (torch.arange(n), perm)):
        ta = (heavy[a], hi[a], lo[a])
        tb = (heavy[b], hi[b], lo[b])
        assert torch.equal(packed[a] < packed[b], hashing.hash_lt(ta, tb))
        assert torch.equal(packed[a] == packed[b], hashing.hash_eq(ta, tb))
    # the pairs include ties (equal hashes) and both orders
    assert bool((packed[:-1] == packed[1:]).any()) or not ties


@pytest.mark.parametrize("k_arg,m,R,L,adds,bound_by", [
    (31, 11, 2048, 542, 0, "bytes"),             # clean offsets only
    (63, 21, 1024, 574, (1024 * 574 * 20 + 1) * 40, "operations"),
    (62, 21, 1024, 62, (1024 * 62 * 20 + 1) * 40, "operations"),
    (63, 23, 65536, 63, (65536 * 63 * 22 + 1) * 44, "operations"),
    (45, 21, 10, 84, 10 * 84 * 13 * 40, "bytes"),  # no i >= 32
])
def test_rescan_bound_counts_what_the_inputs_need(k_arg, m, R, L, adds,
                                                  bound_by):
    """bench_enumerate's rescan bound: two decycling sums of m-1 float64
    additions per position for each truncated offset clean_max < i < 32,
    once per call for the constant candidate of the offsets i >= 32, at
    the card's float64 addition rate (17e12/s, an FMA counting two
    operations in the data sheet's 34 TFLOP/s)."""
    from brisk_tpu_torch import bench_enumerate
    bytes_, fp64 = bench_enumerate.rescan_work(R, L, k_arg, m, False)
    assert fp64 == adds and bytes_ == R * L * 122
    b = bench_enumerate.bound(bytes_, fp64)
    assert b["bound_by"] == bound_by
    assert b["bound_ms"] == pytest.approx(
        max(bytes_ / 3.35e12, adds / 17e12) * 1e3, rel=1e-12)
    if (k_arg, m, L) == (63, 21, 574):  # the k=63 streaming batch
        assert adds == 470_220_840
        assert b["bound_ms"] == pytest.approx(0.027660, abs=1e-6)
