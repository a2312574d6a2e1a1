"""The plain versions of the flush's three CUDA kernels, held on the CPU at
the kernels' exact contract against the JAX package: the same
numpy-seeded codes go through `brisk_tpu` and the port, every comparison
is exact (integer data, tolerance 0), at (k, m, b) = (31, 11, 8),
(21, 11, 8) and (63, 21, 14).

* `ops.minimizer.position_pipeline_torch` (plain version of
  kernels.positions, csrc/positions.cu) against
  `brisk_tpu.ops.minimizer.position_pipeline`: every PositionArrays
  field over a batch and over the fresh-lane init's strided
  `codes[:, :k-1]` at k-1.
* `ops.enumerate._emit_torch` (plain version of kernels.emit,
  csrc/emit.cu) fed the reference's own state-machine rows: the emitted
  k-mer, key, bucket, minimizer index, minimizer and hash against
  `brisk_tpu.ops.enumerate.enumerate_batch`'s.
* `index.sklstore.rows_from_emissions_torch` (plain version of
  kernels.skl_rows, csrc/skl_rows.cu) against
  `brisk_tpu.index.sklstore.rows_from_emissions` on the reference's
  emissions with ragged valid spans: row_cap 4 (overflow lanes, their
  padding slots), row_cap past the lane (every slot), the k=63 split
  runs; and the slice as a whole, enumerate_batch then the rows, port
  against reference.
* The wrappers: on the CPU the routed functions are the plain versions
  and launch nothing; the CUDA wrappers reject CPU tensors and bad
  shapes before any build.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import sklstore as j_skl
from brisk_tpu.ops import decycling as j_dec
from brisk_tpu.ops import enumerate as j_enum
from brisk_tpu.ops import minimizer as j_min
from brisk_tpu_torch import kernels
from brisk_tpu_torch.index import sklstore as t_skl
from brisk_tpu_torch.ops import decycling, hashing
from brisk_tpu_torch.ops import enumerate as t_enum
from brisk_tpu_torch.ops import minimizer as t_min

torch.set_num_threads(2)

CONFIGS = [(31, 11, 8), (21, 11, 8), (63, 21, 14)]


def _t(x) -> torch.Tensor:
    """JAX or numpy array -> torch (bool kept, integers as int64)."""
    a = np.asarray(x)
    return torch.from_numpy(a.copy() if a.dtype == bool
                            else a.astype(np.int64))


def _eq(a, b, what: str) -> None:
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  b.numpy().astype(np.int64), err_msg=what)


def _codes(shape, seed: int) -> np.ndarray:
    """Random 2-bit codes with a poly-A run and a palindromic repeat."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, shape, dtype=np.uint8)
    n = shape[-1]
    codes[0, 5:n - 5] = 0
    codes[1, :] = np.resize([0, 1, 3, 2, 2, 3, 1, 0], n)
    return codes


def _assert_positions_equal(jpa, tpa) -> None:
    for f, a, b in zip(j_min.PositionArrays._fields, jpa, tpa):
        if isinstance(a, tuple):
            for i, (x, y) in enumerate(zip(a, b)):
                _eq(x, y, f"{f}[{i}]")
                assert y.dtype == torch.int64
        else:
            _eq(a, b, f)
            assert b.dtype == torch.bool


@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_position_pipeline_plain_version_matches_reference(k, m, b):
    """A batch's every position, and the fresh-lane init over the strided
    slice codes[:, :k-1] at k-1 (k-1 = 30, 20, 62: the reverse
    complement deposits below bit 0 at m = 11 and 21)."""
    codes = _codes((5, k - 1 + 70), seed=k)
    t_codes = torch.from_numpy(codes.astype(np.int64))
    _assert_positions_equal(j_min.position_pipeline(jnp.asarray(codes), k, m),
                            t_min.position_pipeline_torch(t_codes, k, m))
    init = t_codes[:, :k - 1]
    assert not init.is_contiguous()
    _assert_positions_equal(
        j_min.position_pipeline(jnp.asarray(codes[:, :k - 1]), k - 1, m),
        t_min.position_pipeline_torch(init, k - 1, m))


ROW_CAPS = (4, 24, 200)  # most lanes overflow; kept rows then padding; all


def _rows_inputs(jem, vs, margin: int):
    """The reference's emissions as rows_from_emissions inputs (numpy):
    valid cut ragged inside each lane, first_valid at valid_start (the
    windowed insert) or column 0 (the streaming insert)."""
    B, L = np.asarray(jem.bucket).shape
    pos = np.arange(L)[None, :]
    start = (np.zeros(B, np.int64) if vs is None
             else vs.astype(np.int64) - margin)
    valid = np.asarray(jem.valid) & (pos >= start[:, None])
    valid[2, L // 3: L // 3 + 5] = False  # a hole inside a lane
    first_valid = pos == start[:, None]
    return [np.asarray(x) for x in (jem.key, jem.bucket, jem.mini_idx,
                                    jem.use_rc)] + [valid, first_valid,
                                                    np.asarray(jem.boundary)]


@functools.lru_cache(maxsize=None)
def _reference(k: int, m: int, b: int) -> dict:
    """The reference's enumerate_batch (windowed at k <= 32, streaming at
    k = 63) on random codes of 7 lanes x 150 emitting positions with
    ragged valid_end and valid_start, and its rows_from_emissions at
    each of ROW_CAPS on those emissions (_rows_inputs): computed once a
    configuration, shared by the tests below."""
    B, L_out, margin = 7, 150, k - 1
    rng = np.random.default_rng(k)
    codes = _codes((B, margin + L_out), k)
    fresh = np.ones(B, bool)
    ve = rng.integers(margin + L_out // 2, margin + L_out + 1, B,
                      dtype=np.int32)
    ve[-1] = margin + 1  # one k-mer
    vs = (rng.integers(margin, margin + L_out // 4, B, dtype=np.int32)
          if k <= 32 else None)
    jem, _ = j_enum.enumerate_batch(
        jnp.asarray(codes), jnp.asarray(fresh), jnp.asarray(ve),
        j_enum.zero_carry(B), k=k, m=m, b=b,
        valid_start=None if vs is None else jnp.asarray(vs))
    rows_in = _rows_inputs(jem, vs, margin)
    rows = {cap: j_skl.rows_from_emissions(
        *(jnp.asarray(x) for x in rows_in), k, m, b, cap)
        for cap in ROW_CAPS}
    return dict(codes=codes, fresh=fresh, ve=ve, vs=vs, jem=jem,
                rows_in=rows_in, rows=rows)


@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_emit_plain_version_matches_reference(k, m, b):
    """_emit_torch on the reference's own machine rows (rev, pos, the
    packed minimizer, the packed hash with its class) and the port's
    position arrays gives the reference's mini_idx, minimizer, hash,
    emitted k-mer, key and bucket."""
    ref = _reference(k, m, b)
    jem = ref["jem"]
    km = k - m
    rev = _t(jem.use_rc)
    mini_idx = _t(jem.mini_idx)
    pos = torch.where(rev, km - mini_idx, mini_idx)
    mini = _t(jem.mini_lo) | (_t(jem.mini_hi) << 32)
    heavy = _t(j_dec.mem_double(jem.mini_lo, jem.mini_hi, m))
    h = hashing.pack_hash(heavy, _t(jem.hash_hi), _t(jem.hash_lo))
    pa = t_min.position_pipeline_torch(
        torch.from_numpy(ref["codes"].astype(np.int64)), k, m)
    got = t_enum._emit_torch(rev, pos, mini, h, pa.fwd_k, pa.rc_k, k, m, b)
    for name, g in zip(("mini_idx", "mini_lo", "mini_hi", "hash_hi",
                        "hash_lo", "kmer", "key", "bucket"), got):
        _eq(getattr(jem, name), g, name)
        assert g.dtype == torch.int64
    assert bool(rev.any()) and bool((~rev).any())


def _torch_args(np_in):
    return [torch.from_numpy(x.copy() if x.dtype == bool
                             else x.astype(np.int64)) for x in np_in]


def _assert_rows_equal(jo, to, row_cap: int) -> None:
    for name, a, c in zip(("bucket", "meta", "nucs", "overflow"), jo, to):
        _eq(a, c, f"{name} at row_cap {row_cap}")
        assert c.dtype == (torch.bool if name == "overflow" else torch.int64)


@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_rows_plain_version_matches_reference(k, m, b):
    """rows_from_emissions_torch against the reference at row_cap 4 (most
    lanes overflow: every slot is a padding position), at a row_cap
    between (kept rows, then padding) and past the lane (every
    position has its slot); each configuration splits runs longer than
    s_max (2(k - m) + 1 > 8)."""
    ref = _reference(k, m, b)
    _, s_max, _, _ = t_skl.skl_dims(k, m, b)
    assert 2 * (k - m) + 1 > s_max
    for row_cap in ROW_CAPS:
        to = t_skl.rows_from_emissions_torch(*_torch_args(ref["rows_in"]),
                                             k, m, b, row_cap)
        _assert_rows_equal(ref["rows"][row_cap], to, row_cap)
        if row_cap == 4:
            assert bool(to[3].any())
        if row_cap == 200:
            assert to[0].shape[1] == 150 and not bool(to[3].any())


@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_flush_slice_matches_reference(k, m, b):
    """The slice as a whole on the CPU: enumerate_batch (the plain
    position pipeline, rescan, state machine and epilogue behind its
    routed calls) then rows_from_emissions (its plain version) equal the
    reference's, every Emissions field and every row output."""
    ref = _reference(k, m, b)
    jem, vs = ref["jem"], ref["vs"]
    tem, _ = t_enum.enumerate_batch(
        torch.from_numpy(ref["codes"]), torch.from_numpy(ref["fresh"]),
        torch.from_numpy(ref["ve"]), t_enum.zero_carry(7), k, m, b,
        valid_start=None if vs is None else torch.from_numpy(vs))
    for f in j_enum.Emissions._fields:
        a, c = getattr(jem, f), getattr(tem, f)
        for x, y in zip(a, c) if f == "replay" else ((a, c),):
            _eq(x, y, f)
    t_in = _torch_args(ref["rows_in"])
    t_in[:4] = tem.key, tem.bucket, tem.mini_idx, tem.use_rc
    for row_cap in ROW_CAPS:
        _assert_rows_equal(ref["rows"][row_cap],
                           t_skl.rows_from_emissions(*t_in, k, m, b,
                                                     row_cap), row_cap)


def test_routed_functions_take_the_plain_versions_on_the_cpu():
    """On CPU tensors position_pipeline, _emit and rows_from_emissions are
    their plain versions and launch nothing."""
    k, m, b = 31, 11, 8
    codes = torch.from_numpy(_codes((3, 70), seed=1).astype(np.int64))
    before = dict(kernels.LAUNCHES)
    pa = t_min.position_pipeline(codes, k, m)
    _assert_positions_equal(t_min.position_pipeline_torch(codes, k, m), pa)
    res = t_min.windowed_get_minimizer_torch(pa, pa.fwd_k, k, m)
    fresh = torch.ones(3, dtype=torch.bool)
    rows, _ = t_enum._state_machine_torch(t_enum.zero_carry(3), pa, res,
                                          fresh, k - m, k - 1)
    args = (rows[1], rows[2], rows[3], rows[4], pa.fwd_k, pa.rc_k, k, m, b)
    for x, y in zip(t_enum._emit(*args), t_enum._emit_torch(*args)):
        assert torch.equal(x, y)
    em, _ = t_enum.enumerate_batch(codes, fresh, torch.full((3,), 70),
                                   t_enum.zero_carry(3), k, m, b)
    first_valid = torch.zeros_like(em.valid)
    first_valid[:, 0] = True
    rargs = (em.key, em.bucket, em.mini_idx, em.use_rc, em.valid,
             first_valid, em.boundary, k, m, b, 4)
    for x, y in zip(t_skl.rows_from_emissions(*rargs),
                    t_skl.rows_from_emissions_torch(*rargs)):
        assert torch.equal(x, y)
    assert kernels.LAUNCHES == before


def test_flush_wrappers_reject_bad_inputs_before_any_build():
    """No fallback: CPU tensors and bad shapes raise before a build is
    tried (this machine has no nvcc: a build would raise RuntimeError)."""
    k, m, b = 31, 11, 8
    codes = torch.from_numpy(_codes((3, 70), seed=2).astype(np.int64))
    coef = decycling.coef_table(m, torch.device("cpu"))
    pa = t_min.position_pipeline_torch(codes, k, m)
    em, _ = t_enum.enumerate_batch(codes, torch.ones(3, dtype=torch.bool),
                                   torch.full((3,), 70),
                                   t_enum.zero_carry(3), k, m, b)
    L_out = em.use_rc.shape[1]
    i64 = torch.zeros((3, L_out), dtype=torch.int64)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.positions(codes, coef, k, m)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.positions(codes, coef, k, 32)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.positions(codes[0], coef, k, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.emit(em.use_rc, i64, i64, i64, pa.fwd_k, pa.rc_k, k, m, b)
    with pytest.raises(ValueError, match="expected 4"):
        kernels.emit(em.use_rc, i64, i64, i64, pa.fwd_k[:3], pa.rc_k, k, m,
                     b)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.emit(em.use_rc, i64, i64, i64, pa.fwd_k, pa.rc_k, k, m, 16)
    rargs = [em.key, em.bucket, em.mini_idx, em.use_rc, em.valid, em.valid,
             em.boundary]
    _, s_max, _, nw = t_skl.skl_dims(k, m, b)
    dims = (s_max, nw, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.skl_rows(*rargs, k, m, b, 4, *dims)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.skl_rows(em.key[:3], *rargs[1:], k, m, b, 4, *dims)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.skl_rows(*rargs, k, m, b, -1, *dims)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.skl_rows(*rargs, k, m, b, 4, s_max, 7, True)
    assert kernels.LAUNCHES == before
    assert not kernels._libs
