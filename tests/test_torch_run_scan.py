"""The run scan of the query join and of compact, on the CPU.

`brisk_tpu_torch/csrc/run_scan.cu` holds two kernels over one segmented
scan of sorted slots: the join's scan after its sort (kernels.join_scan,
plain version index.sklstore._join_scan_torch) and compact's run totals
(kernels.run_totals, plain version index.store._run_totals_torch). Here

- the port's `_query_join_partials` and `store.compact`, which take the
  plain versions on CPU tensors, are held to brisk_tpu's on the same
  numpy-seeded inputs: the (256,) partials element for element, and
  keys, data and n_sorted array for array;
- g++ builds the kernels' arithmetic, `csrc/run_scan.cuh`, with
  `tests/run_scan_host.cpp`, which replays the kernels' one pass (tiles
  taken in order, warps of groups of one slot a lane, each tile's
  decoupled look-back over its predecessors' descriptors) with 4-lane
  groups and tiles of 4, 8 and 16 slots, under look-back schedules that
  decide which predecessors a tile sees as unpublished, as their
  aggregate or as their prefix (SCHEDULES), and ctypes holds the replay
  to the plain versions.

Every comparison is exact (integer data, tolerance 0). Cases: a run whose
index counts sum past 2^32, all-index and all-query batches, one long
run, S of 1, S not a multiple of 256, INVALID padding, runs across tiles.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import sklstore as j_skl
from brisk_tpu.index import store as j_store
from brisk_tpu_torch import _u32, kernels
from brisk_tpu_torch.index import sklstore as t_skl
from brisk_tpu_torch.index import store as t_store
from run_scan_cases import join_inputs, run_inputs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
INVALID = 0xFFFFFFFF
BIG = (1 << 31) + 12345  # three of these in one run pass 2^32


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The header and its host replay, built with g++ (skip without
    it)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/run_scan.cuh on the host")
    so = str(tmp_path_factory.mktemp("run_scan") / "librun_scan_host.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "brisk_tpu_torch", "csrc"),
         os.path.join(REPO, "tests", "run_scan_host.cpp"), "-o", so],
        check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.host_join_scan.argtypes = [_PTR] * 3 + [_LL, _INT, _INT, _INT]
    lib.host_run_totals.argtypes = [_PTR] * 4 + [_LL, _INT, _INT]
    for fn in (lib.host_join_scan, lib.host_run_totals):
        fn.restype = ctypes.c_int
    return lib


def _keys(rng, W, n, n_distinct):
    """n packed keys (W, n) uint32 drawn from n_distinct, the reserved top
    bit clear."""
    pool = rng.integers(0, 1 << 32, (W, n_distinct), dtype=np.uint64)
    pool = pool.astype(np.uint32)
    pool[0] &= 0x7FFFFFFF
    return pool[:, rng.integers(0, n_distinct, n)]


def _join_case(name: str, W: int = 3, seed: int = 0):
    """(ikeys, icnt, qkeys, qlive) numpy uint32 for one named case."""
    rng = np.random.default_rng(seed)
    if name == "random":
        ik = _keys(rng, W, 3000, 700)
        ic = rng.integers(0, 400, 3000).astype(np.uint32)
        qk = np.concatenate([_keys(rng, W, 1500, 700), ik[:, :600]], 1)
        ql = (rng.random(qk.shape[1]) < 0.9).astype(np.uint32)
    elif name == "wrap":
        # the largest key holds index counts summing past 2^32 (it is the
        # last live run, so the reference's u32 running sum stays right)
        ik = _keys(rng, W, 400, 150)
        top = np.full((W, 1), 0x7FFFFFFF, np.uint32)
        ik = np.concatenate([ik, np.repeat(top, 5, 1)], 1)
        ic = rng.integers(0, 300, ik.shape[1]).astype(np.uint32)
        ic[-5:] = [BIG, BIG, 7, BIG, 0xFFFFFFFF]
        qk = np.concatenate([ik[:, :200], np.repeat(top, 9, 1)], 1)
        ql = np.ones(qk.shape[1], np.uint32)
    elif name == "all-index":
        ik = _keys(rng, W, 1000, 300)
        ic = rng.integers(0, 256, 1000).astype(np.uint32)
        qk = np.full((W, 300), INVALID, np.uint32)
        ql = np.zeros(300, np.uint32)
    elif name == "all-query":
        ik = np.full((W, 500), INVALID, np.uint32)
        ic = np.zeros(500, np.uint32)
        qk = _keys(rng, W, 700, 200)
        ql = np.ones(700, np.uint32)
    elif name == "long-run":
        key = _keys(rng, W, 1, 1)
        ik = np.repeat(key, 1100, 1)
        ic = rng.integers(0, 1 << 20, 1100).astype(np.uint32)
        qk = np.repeat(key, 900, 1)
        ql = (rng.random(900) < 0.7).astype(np.uint32)
    elif name == "s1-index":
        ik = _keys(rng, W, 1, 1)
        ic = np.array([3], np.uint32)
        qk, ql = np.zeros((W, 0), np.uint32), np.zeros(0, np.uint32)
    elif name == "s1-query":
        ik, ic = np.zeros((W, 0), np.uint32), np.zeros(0, np.uint32)
        qk, ql = _keys(rng, W, 1, 1), np.ones(1, np.uint32)
    elif name == "ragged":
        ik = _keys(rng, W, 301, 60)
        ic = rng.integers(0, 40, 301).astype(np.uint32)
        qk = np.concatenate([ik[:, :50], _keys(rng, W, 27, 60)], 1)
        ql = np.ones(77, np.uint32)
    else:
        raise ValueError(name)
    if name in ("random", "ragged", "long-run", "wrap"):
        # INVALID padding: dead index slots and padded query slots
        qk[:, :13] = INVALID
        ql[:13] = 0
        ik[:, 1:4] = INVALID
        ic[1:4] = 0
    return ik, ic, qk, ql


JOIN_CASES = ("random", "wrap", "all-index", "all-query", "long-run",
              "s1-index", "s1-query", "ragged")


def _port_join(ik, ic, qk, ql):
    return t_skl._query_join_partials(
        _u32.from_np(ik, "cpu"), torch.from_numpy(ic.astype(np.int64)),
        _u32.from_np(qk, "cpu"), torch.from_numpy(ql.astype(np.int64)))


@pytest.mark.parametrize("W", [3, 6])
@pytest.mark.parametrize("case", JOIN_CASES)
def test_join_partials_match_reference(case, W):
    """The port's _query_join_partials on the CPU equals brisk_tpu's,
    partial for partial."""
    ik, ic, qk, ql = _join_case(case, W, seed=W)
    want = np.asarray(j_skl._query_join_partials(
        jnp.asarray(ik), jnp.asarray(ic), jnp.asarray(qk), jnp.asarray(ql)))
    before = dict(kernels.LAUNCHES)
    got = _port_join(ik, ic, qk, ql)
    assert kernels.LAUNCHES == before  # the CPU takes the plain version
    assert got.dtype == torch.int64 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if case in ("random", "wrap", "long-run", "ragged"):
        assert int(got.sum()) > 0


def test_join_wrap_case_sums_past_2_32():
    """The wrap case's key really sums past 2^32, and its query slots read
    that sum mod 256."""
    ik, ic, qk, ql = _join_case("wrap")
    total = (3 * BIG + 7 + INVALID) % 256
    assert 3 * BIG + 7 + INVALID > 1 << 32
    got = _port_join(ik, ic, qk, ql)
    alone = _port_join(ik[:, -5:], ic[-5:], qk[:, -9:], ql[-9:])
    assert int(alone.sum()) == 9 * total
    assert int(got.sum()) >= 9 * total


def test_join_wraps_each_run_on_its_own():
    """Index counts that pass 2^32 in the first key's run, then other keys
    with query slots: each query slot reads its own key's index sum mod
    256 (numpy), as the port's int64 sums and the kernel's u32 run sums
    give it (the reference's u32 running sum feeds a cummax and is right
    only while it does not wrap)."""
    rng = np.random.default_rng(12)
    ik = _keys(rng, 3, 900, 200)
    ik[:, :4] = 0  # the smallest key, sorted first
    ic = rng.integers(0, 1 << 32, 900, dtype=np.uint64).astype(np.uint32)
    ic[:4] = BIG
    qk = np.concatenate([ik[:, :700], _keys(rng, 3, 300, 200)], 1)
    ql = (rng.random(1000) < 0.8).astype(np.uint32)
    sums = {}
    for j in range(900):
        key = tuple(ik[:, j])
        sums[key] = sums.get(key, 0) + int(ic[j])
    want = sum(sums.get(tuple(qk[:, j]), 0) % 256
               for j in range(1000) if ql[j])
    assert int(_port_join(ik, ic, qk, ql).sum()) == want > 0


def _capture_join(monkeypatch, case: str, W: int, seed: int):
    """The sorted words and payload the join hands its scan, and the plain
    version's partials."""
    seen = {}
    real = t_skl._join_scan_torch

    def capture(out, s_pay):
        seen["in"] = (out.clone(), s_pay.clone())
        return real(out, s_pay)

    monkeypatch.setattr(t_skl, "_join_scan_torch", capture)
    want = _port_join(*_join_case(case, W, seed))
    return seen["in"], want


# The replay's look-back schedules (tests/run_scan_host.cpp): every
# predecessor seen as its prefix; every one as only its aggregate (the
# look-back walks to the start unless the join's stop rule ends it); two
# seeded mixes of unpublished, aggregate and prefix.
SCHEDULES = {"prefix": 0, "aggregate": 1, "seeded-2": 2, "seeded-3": 3}


def _host_join(lib, out, s_pay, tile, schedule):
    parts = torch.empty(256, dtype=torch.int64)
    out, s_pay = out.contiguous(), s_pay.contiguous()
    assert lib.host_join_scan(out.data_ptr(), s_pay.data_ptr(),
                              parts.data_ptr(), out.shape[1], out.shape[0],
                              tile, SCHEDULES[schedule]) == 0
    return parts


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("case", JOIN_CASES)
def test_join_replay_matches_plain_version(lib, monkeypatch, case, tile,
                                           schedule):
    """The kernel's pass over the join's own sorted slots gives the plain
    version's partials (runs across 4- and 8-slot tiles), whatever its
    look-backs see."""
    (out, s_pay), want = _capture_join(monkeypatch, case, 3, seed=tile)
    assert torch.equal(_host_join(lib, out, s_pay, tile, schedule), want)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("n", [1, 3, 4, 5, 8, 9, 33, 256, 257, 1000])
@pytest.mark.parametrize("max_run", [3, 40])
def test_join_replay_on_long_and_short_runs(lib, n, max_run, schedule):
    """Synthetic sorted runs, some longer than several tiles, with index
    counts past 2^31 and query slots of liveness 0, 1 and 2 (2 reads
    nothing): the replay equals the plain version at tiles of 4, 8 and
    16 (two warps of two groups)."""
    for W in (1, 3):
        words, pay = join_inputs(n, W, max_run, seed=n + max_run + W)
        want = t_skl._join_scan_torch(words, pay)
        for tile in (4, 8, 16):
            assert torch.equal(
                _host_join(lib, words, pay, tile, schedule), want)


def _host_totals(lib, data, first, tile, schedule):
    n = data.shape[0]
    out = torch.empty((2, n), dtype=torch.int64)
    assert lib.host_run_totals(first.data_ptr(), data.data_ptr(),
                               out[0].data_ptr(), out[1].data_ptr(), n,
                               tile, SCHEDULES[schedule]) == 0
    return out[0], out[1]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("n", [1, 2, 4, 7, 8, 9, 64, 300, 1025])
@pytest.mark.parametrize("max_run", [2, 50])
def test_run_totals_replay_matches_plain_version(lib, n, max_run,
                                                 schedule):
    """Run totals and run indices of the replay equal the plain version's
    at tiles of 4, 8 and 16: runs shorter than a group and runs across
    many tiles, counts whose run sums pass 2^32, whatever the look-backs
    see."""
    data, first = run_inputs(n, max_run, seed=n * max_run)
    want = t_store._run_totals_torch(data, first)
    for tile in (4, 8, 16):
        got = _host_totals(lib, data, first, tile, schedule)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _compact_case(name: str, rng):
    """(keys (W, cap) uint32, data (cap,) uint32, n_used)."""
    W, cap = 3, 2048
    if name == "random":
        keys = _keys(rng, W, cap, 500)
        data = rng.integers(0, 9, cap).astype(np.uint32)
        n_used = 1700
    elif name == "wrap":
        # the largest key's counts sum past 2^32 (the last live run, so
        # the reference's u32 running sum stays right)
        keys = _keys(rng, W, cap, 400)
        keys[:, 100:104] = 0x7FFFFFFF
        data = rng.integers(0, 9, cap).astype(np.uint32)
        data[100:104] = [BIG, BIG, 3, INVALID]
        n_used = 1500
    elif name == "long-run":
        keys = np.repeat(_keys(rng, W, 1, 1), cap, 1)
        data = rng.integers(0, 1 << 20, cap).astype(np.uint32)
        n_used = cap
    elif name == "one-column":
        keys = np.full((W, cap), INVALID, np.uint32)
        keys[:, :1] = _keys(rng, W, 1, 1)
        data = np.zeros(cap, np.uint32)
        data[0] = 5
        n_used = 1
    else:
        raise ValueError(name)
    keys[:, n_used:] = INVALID
    data[n_used:] = 0
    if name in ("random", "wrap"):
        keys[:, 7:11] = INVALID  # tombstones inside the used log
        data[7:11] = 0
    return keys, data, n_used


@pytest.mark.parametrize("case", ["random", "wrap", "long-run",
                                  "one-column"])
def test_compact_matches_reference(case):
    """The port's store.compact on the CPU equals brisk_tpu's: keys, data
    and n_sorted."""
    keys, data, n_used = _compact_case(case, np.random.default_rng(5))
    js = j_store.compact(j_store.IndexState(
        jnp.asarray(keys), jnp.asarray(data), jnp.int32(0),
        jnp.int32(n_used)))
    before = dict(kernels.LAUNCHES)
    ts = t_store.compact(t_store.IndexState(
        _u32.from_np(keys, "cpu"), torch.from_numpy(data.astype(np.int64)),
        0, n_used))
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(_u32.to_np(ts.keys), np.asarray(js.keys))
    np.testing.assert_array_equal(ts.data.numpy(),
                                  np.asarray(js.data).astype(np.int64))
    assert ts.n_sorted == ts.n_used == int(js.n_sorted)
    if case == "wrap":
        assert int(ts.data[ts.n_sorted - 1]) == (2 * BIG + 3 + INVALID) & \
            _u32.M32


def test_compact_wraps_each_run_on_its_own():
    """A run whose counts pass 2^32 before other runs: every total is its
    own run's sum mod 2^32 (numpy), the port's int64 sums and the kernel's
    u32 sums alike (the reference's u32 running sum feeds a cummax and
    is right only while it does not wrap)."""
    rng = np.random.default_rng(11)
    keys = _keys(rng, 2, 600, 120)
    keys[:, :3] = 0  # the smallest key, sorted first
    data = rng.integers(0, 1 << 32, 600, dtype=np.uint64).astype(np.uint32)
    data[:3] = [BIG, BIG, BIG]
    ts = t_store.compact(t_store.IndexState(
        _u32.from_np(keys, "cpu"), torch.from_numpy(data.astype(np.int64)),
        0, 600))
    uniq, inv = np.unique(keys.T, axis=0, return_inverse=True)
    sums = np.zeros(len(uniq), np.uint64)
    np.add.at(sums, inv.reshape(-1), data.astype(np.uint64))
    assert ts.n_sorted == len(uniq)
    np.testing.assert_array_equal(_u32.to_np(ts.keys)[:, :len(uniq)],
                                  uniq.T)
    np.testing.assert_array_equal(ts.data[:len(uniq)].numpy(),
                                  (sums & 0xFFFFFFFF).astype(np.int64))


def test_scan_tile_keeps_tiles_whole_and_few():
    """The kernels' tile, one a block: a power of two from 256 slots (8
    warps of one 32-slot group) to 4,096 (16 groups a warp), at most 2,048
    tiles until the tile is 4,096."""
    for n in (1, 31, 32, 256, 257, 1 << 17, (1 << 19) + 1, 1 << 20,
              (1 << 20) + 1, 1 << 23, 1 << 25, (1 << 31) - 1):
        tile = kernels._scan_tile(n)
        assert tile & (tile - 1) == 0 and 256 <= tile <= 4096
        assert -(-n // tile) <= 2048 or tile == 4096
        assert tile == 256 or -(-n // (tile // 2)) > 2048


def test_run_scan_wrappers_reject_bad_inputs_before_any_build():
    """kernels.join_scan and kernels.run_totals refuse CPU tensors, other
    dtypes and shapes before they build or launch anything."""
    before = dict(kernels.LAUNCHES)
    words = torch.zeros((3, 10), dtype=torch.int64)
    pay = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.join_scan(words, pay)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.join_scan(torch.zeros((7, 10), dtype=torch.int64), pay)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.join_scan(pay, pay)
    first = torch.ones(10, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.run_totals(pay, first)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.run_totals(words, first)
    assert kernels.LAUNCHES == before
    assert not any(path.endswith("run_scan.cu") for path, _ in kernels._libs)
