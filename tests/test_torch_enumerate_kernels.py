"""The plain versions of the enumerator's two CUDA kernels, held on the CPU
at the kernels' exact contract against the JAX package: the same
numpy-seeded codes go through `brisk_tpu` and the port, every comparison
is exact (integer data, tolerance 0).

* `ops.minimizer.windowed_get_minimizer_torch` (plain version of
  kernels.rescan, csrc/rescan.cu) against
  `brisk_tpu.ops.minimizer.windowed_get_minimizer`: every MinimizerState
  field and the unique-minimum flags, over the (B, L_buf) batch, the
  fresh-lane init over the margin at k_arg = k-1, the (N, k) rows of
  `rekey._rekey_batch`, and a tie-heavy input.
* `ops.enumerate._state_machine_torch` (plain version of
  kernels.state_scan, csrc/state_scan.cu) fed the reference's own inputs
  (its position arrays, rescan and initial state): every per-position
  output and the final state against `brisk_tpu.ops.enumerate.
  enumerate_batch`, windowed at k=31 and streaming at k=63 over two
  batches with the carry.
* The wrappers: on the CPU the routed functions are the plain versions;
  the CUDA wrappers reject CPU tensors and bad shapes before any build.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.ops import decycling as j_dec
from brisk_tpu.ops import enumerate as j_enum
from brisk_tpu.ops import minimizer as j_min
from brisk_tpu.ops import revcomp as j_rc
from brisk_tpu_torch import kernels
from brisk_tpu_torch.ops import enumerate as t_enum
from brisk_tpu_torch.ops import minimizer as t_min

torch.set_num_threads(2)


def _t(x) -> torch.Tensor:
    """JAX or numpy array -> torch (bool kept, integers as int64)."""
    a = np.asarray(x)
    return torch.from_numpy(a.copy() if a.dtype == bool
                            else a.astype(np.int64))


def _tt(xs) -> tuple:
    return tuple(_t(x) for x in xs)


def _eq(a, b, what: str) -> None:
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  b.numpy().astype(np.int64), err_msg=what)


def _codes(shape, seed: int, ties: bool = False) -> np.ndarray:
    """Random 2-bit codes; with `ties`, low-entropy rows (poly-A, period
    2, 4 and 8 palindromic repeats) whose m-mer hashes tie across the
    window."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, shape, dtype=np.uint8)
    if ties:
        n = shape[-1]
        codes[..., 0, :] = 0
        codes[..., 1, :] = np.resize([0, 1], n)
        codes[..., 2, :] = np.resize([0, 1, 3, 2], n)
        codes[..., 3, 3:n - 3] = np.resize([0, 1, 3, 2, 2, 3, 1, 0], n - 6)
    return codes


def _rescan_pair(codes: np.ndarray, k_arg: int, m: int, with_unique: bool):
    jpa = j_min.position_pipeline(jnp.asarray(codes), k_arg, m)
    tpa = t_min.position_pipeline(torch.from_numpy(codes.astype(np.int64)),
                                  k_arg, m)
    jr = j_min.windowed_get_minimizer(jpa, jpa.fwd_k, k_arg, m,
                                      with_unique=with_unique)
    tr = t_min.windowed_get_minimizer_torch(tpa, tpa.fwd_k, k_arg, m,
                                            with_unique=with_unique)
    return jpa, tpa, jr, tr


def _assert_rescan_equal(jr, tr, with_unique: bool) -> None:
    if with_unique:
        _eq(jr[1], tr[1], "unique")
        jr, tr = jr[0], tr[0]
    for f, a, b in zip(j_min.MinimizerState._fields, jr, tr):
        _eq(a, b, f)
        assert b.dtype == (torch.bool if f == "rev" else torch.int64), f


@pytest.mark.parametrize("name,k,m,shape,with_unique", [
    ("k31-windowed-batch", 31, 11, (5, 30 + 97), True),
    ("k63-streaming-batch", 63, 21, (4, 62 + 75), False),
    ("k31-fresh-init", 30, 11, (7, 30), False),
    ("k63-fresh-init", 62, 21, (7, 62), False),
    ("k31-rekey-rows", 31, 11, (300, 31), False),
    ("k63-rekey-rows", 63, 21, (300, 63), False),
    ("k63-rekey-rows-reallocated", 63, 23, (300, 63), False),
])
def test_rescan_plain_version_matches_reference(name, k, m, shape,
                                                with_unique):
    """The (B, L_buf) rescan of a batch, the fresh-lane init over
    codes[:, :margin] at k_arg = k-1 (its last column is the init state),
    and the (N, k) rows of rekey._rekey_batch (k=63 also at reallocate's
    m=23); k=63 reaches the truncated offsets past clean_max."""
    codes = _codes(shape, seed=k * 101 + shape[0])
    _, _, jr, tr = _rescan_pair(codes, k, m, with_unique)
    _assert_rescan_equal(jr, tr, with_unique)


@pytest.mark.parametrize("k,m", [(31, 11), (63, 21)])
def test_rescan_plain_version_on_ties(k, m):
    """Low-entropy rows: offsets tie the running minimum (cnt > 1), so the
    mirror rule and, where the k-mer is not canonized, the strand rule
    decide; every field still equals the reference's."""
    codes = _codes((6, k - 1 + 90), seed=k, ties=True)
    with_unique = k <= 32
    jpa, _, jr, tr = _rescan_pair(codes, k, m, with_unique)
    _assert_rescan_equal(jr, tr, with_unique)
    if with_unique:
        tied = ~tr[1][:4, k - 1:]
        assert int(tied.sum()) > 100
        canon = np.asarray(j_rc.canonized_k(jpa.fwd_k, k))[:4, k - 1:]
        # ties on both strands: the strand rule can clear rev or not
        assert canon[tied.numpy()].any() and (~canon[tied.numpy()]).any()


def _reference_machine_inputs(codes, fresh, carry, k, m):
    """The reference's own inputs of its state machine: position arrays,
    rescan, and the initial state (the init over the margin for fresh
    lanes, else the carry), as torch tensors."""
    margin = k - 1
    jpa = j_min.position_pipeline(jnp.asarray(codes), k, m)
    jres = j_min.windowed_get_minimizer(jpa, jpa.fwd_k, k, m)
    jpi = j_min.position_pipeline(jnp.asarray(codes[:, :margin]), k - 1, m)
    init = j_min.windowed_get_minimizer(jpi, jpi.fwd_k, k - 1, m)
    state0 = t_min.MinimizerState(*(
        torch.where(torch.from_numpy(fresh), _t(np.asarray(i)[:, -1]), c)
        for i, c in zip(init, carry)))
    pa = t_min.PositionArrays(*(
        _tt(f) if isinstance(f, tuple) else _t(f) for f in jpa))
    return pa, t_min.MinimizerState(*_tt(jres)), state0


def _assert_machine_matches(jem, jfin, rows, final, k, m) -> None:
    bd, rev, pos, mini, h = rows
    km = k - m
    _eq(jem.boundary, bd, "boundary")
    _eq(jem.use_rc, rev, "rev")
    _eq(np.where(np.asarray(jem.use_rc), km - np.asarray(jem.mini_idx),
                 np.asarray(jem.mini_idx)), pos, "pos")
    _eq(np.asarray(jem.mini_lo).astype(np.int64)
        | (np.asarray(jem.mini_hi).astype(np.int64) << 32), mini, "mini")
    key = h & ((1 << 62) - 1)
    _eq(jem.hash_hi, key >> 32, "hash_hi")
    _eq(jem.hash_lo, key & 0xFFFFFFFF, "hash_lo")
    # the state's hash is the hash of its minimizer: heavy is its class
    _eq(j_dec.mem_double(jem.mini_lo, jem.mini_hi, m), (h >> 62) + 2,
        "heavy")
    for f, a, b in zip(j_min.MinimizerState._fields, jfin, final):
        _eq(a, b, "final " + f)
        assert b.dtype == (torch.bool if f == "rev" else torch.int64), f
    for t, dt in zip(rows, (torch.bool, torch.bool) + (torch.int64,) * 3):
        assert t.dtype == dt and t.shape == bd.shape


def test_state_machine_plain_version_windowed_k31():
    """k=31 windowed (the insert): fresh lanes, suppressed first boundary,
    and the replay state read back at valid_start - 1."""
    k, m, b = 31, 11, 8
    B, L_buf = 6, 30 + 130
    codes = _codes((B, L_buf), seed=3, ties=True)
    fresh = np.ones(B, bool)
    ve = np.full(B, L_buf, np.int32)
    vs = np.array([30, 42, 42, 60, 42, 31], np.int32)
    carry = t_enum.zero_carry(B)
    jem, jfin = j_enum.enumerate_batch(
        jnp.asarray(codes), jnp.asarray(fresh), jnp.asarray(ve),
        j_enum.zero_carry(B), k=k, m=m, b=b, valid_start=jnp.asarray(vs))
    pa, res, state0 = _reference_machine_inputs(codes, fresh, carry, k, m)
    rows, final = t_enum._state_machine_torch(
        state0, pa, res, torch.from_numpy(fresh), k - m, k - 1)
    _assert_machine_matches(jem, jfin, rows, final, k, m)
    assert not bool(rows[0][:, 0].any()) and bool(rows[0].any())
    # the replay gather of enumerate_batch reads these rows at vs - 1
    # (lane 0's boundary, vs == margin, lies before the buffer: 0)
    ridx = torch.from_numpy(vs.astype(np.int64)) - k
    got = torch.where(ridx >= 0, rows[2][torch.arange(B), ridx], 0)
    _eq(jem.replay.pos, got, "replay pos")


def test_state_machine_plain_version_streaming_k63_with_carry():
    """k=63 streaming over two batches of the same records: the second
    batch's continuing lanes start from the first batch's final state (the
    carry), its fresh lanes from the init; outputs and final states equal
    the reference's in both batches."""
    k, m, b = 63, 21, 14
    B, L_out = 6, 90
    margin = k - 1
    rec = _codes((B, margin + 2 * L_out), seed=63, ties=True)
    batches = (rec[:, :margin + L_out], rec[:, L_out:])
    fresh_by_batch = (np.ones(B, bool),
                      np.array([False, False, False, True, False, True]))
    ve = np.full(B, margin + L_out, np.int32)
    jcarry, tcarry = j_enum.zero_carry(B), t_enum.zero_carry(B)
    for codes, fresh in zip(batches, fresh_by_batch):
        jem, jfin = j_enum.enumerate_batch(
            jnp.asarray(codes), jnp.asarray(fresh), jnp.asarray(ve), jcarry,
            k=k, m=m, b=b)
        pa, res, state0 = _reference_machine_inputs(codes, fresh, tcarry,
                                                    k, m)
        rows, final = t_enum._state_machine_torch(
            state0, pa, res, torch.from_numpy(fresh), k - m, margin)
        _assert_machine_matches(jem, jfin, rows, final, k, m)
        jcarry, tcarry = jfin, final
    # the carry mattered: a continuing lane's first boundary is not
    # suppressed the way a fresh lane's is
    assert not bool(rows[0][3, 0]) and not bool(rows[0][5, 0])


@pytest.mark.parametrize("k,m,b,windowed", [(31, 11, 8, True),
                                           (63, 21, 14, False)])
def test_enumerate_batch_two_batches_match_reference(k, m, b, windowed):
    """The slice as a whole on the CPU: enumerate_batch (both plain
    versions behind its routed calls) over two batches with the carry
    equals the reference's, every Emissions field and the final state."""
    B, L_out = 5, 70
    margin = k - 1
    rec = _codes((B, margin + 2 * L_out), seed=k + 5, ties=True)
    vs = np.full(B, margin + 9, np.int32) if windowed else None
    ve = np.full(B, margin + L_out - 3, np.int32)
    fresh = np.array([True, False, True, False, False])
    jcarry, tcarry = j_enum.zero_carry(B), t_enum.zero_carry(B)
    for i, codes in enumerate((rec[:, :margin + L_out], rec[:, L_out:])):
        fr = np.ones(B, bool) if i == 0 else fresh
        jem, jfin = j_enum.enumerate_batch(
            jnp.asarray(codes), jnp.asarray(fr), jnp.asarray(ve), jcarry,
            k=k, m=m, b=b,
            valid_start=None if vs is None else jnp.asarray(vs))
        tem, tfin = t_enum.enumerate_batch(
            torch.from_numpy(codes), torch.from_numpy(fr),
            torch.from_numpy(ve), tcarry, k, m, b,
            valid_start=None if vs is None else torch.from_numpy(vs))
        for f in j_enum.Emissions._fields:
            a, c = getattr(jem, f), getattr(tem, f)
            if f == "replay":
                for x, y in zip(a, c):
                    _eq(x, y, f)
            else:
                _eq(a, c, f)
        for x, y in zip(jfin, tfin):
            _eq(x, y, "final")
        jcarry, tcarry = jfin, tfin


def test_routed_functions_take_the_plain_versions_on_the_cpu():
    """On CPU tensors _state_machine and windowed_get_minimizer are their
    plain versions and launch nothing."""
    k, m = 31, 11
    codes = torch.from_numpy(_codes((3, 60), seed=1).astype(np.int64))
    pa = t_min.position_pipeline(codes, k, m)
    before = dict(kernels.LAUNCHES)
    a = t_min.windowed_get_minimizer(pa, pa.fwd_k, k, m, with_unique=True)
    b = t_min.windowed_get_minimizer_torch(pa, pa.fwd_k, k, m,
                                           with_unique=True)
    assert torch.equal(a[1], b[1])
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    fresh = torch.ones(3, dtype=torch.bool)
    state0 = t_enum.zero_carry(3)
    r1, f1 = t_enum._state_machine(state0, pa, a[0], fresh, k - m, k - 1)
    r2, f2 = t_enum._state_machine_torch(state0, pa, a[0], fresh, k - m,
                                         k - 1)
    for x, y in zip(list(r1) + list(f1), list(r2) + list(f2)):
        assert torch.equal(x, y)
    assert kernels.LAUNCHES == before


def _wrapper_inputs(B=4, L_buf=40, margin=30):
    i64 = torch.zeros((B, L_buf), dtype=torch.int64)
    bl = torch.zeros((B, L_buf), dtype=torch.bool)
    cand = (i64,) * 5 + (bl,)
    rows7 = (i64,) * 3 + (bl,) + (i64,) * 3
    s = torch.zeros(B, dtype=torch.int64)
    state = (s,) * 3 + (torch.zeros(B, dtype=torch.bool),) + (s,) * 3
    return cand, rows7, state, torch.ones(B, dtype=torch.bool)


def test_state_scan_wrapper_rejects_bad_inputs_before_any_build():
    """No fallback: CPU tensors and bad shapes raise before a build is
    tried (this machine has no nvcc: a build would raise RuntimeError)."""
    cand, rows7, state, fresh = _wrapper_inputs()
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.state_scan(cand, rows7, state, fresh, 20, 30)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.state_scan(cand, rows7, state, fresh, 20, 41)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.state_scan(cand, rows7, state, fresh[:3], 20, 30)
    with pytest.raises(ValueError, match="expected 6"):
        kernels.state_scan(cand[:5], rows7, state, fresh, 20, 30)
    assert kernels.LAUNCHES == before
    assert not kernels._libs


def test_rescan_wrapper_rejects_bad_inputs_before_any_build():
    k, m = 31, 11
    pa = t_min.position_pipeline(
        torch.from_numpy(_codes((2, 40), seed=2).astype(np.int64)), k, m)
    coef = t_min.decycling.coef_table(m, torch.device("cpu"))
    args = (pa.canon_m, pa.cand_hash, pa.scan_rev, pa.fwd_k, coef)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.rescan(*args, k, m, with_unique=True)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.rescan(*args, k, 32)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.rescan(*args, 64, m)
    with pytest.raises(ValueError, match="expected 2"):
        kernels.rescan(pa.canon_m[:1], *args[1:], k, m)
    assert kernels.LAUNCHES == before
    assert not kernels._libs


@pytest.mark.parametrize("m", [11, 21, 23])
def test_coef_table_is_the_reference_table(m):
    """The rescan kernel's float64 table: the host's coefficients, in
    order, bit for bit."""
    from brisk_tpu.oracle import pyref as j_pyref
    got = t_min.decycling.coef_table(m, torch.device("cpu"))
    assert got.dtype == torch.float64 and got.shape == (4 * m,)
    assert got.tolist() == j_pyref.DecyclingSet(m).coef


def test_op_counts_on_the_cpu():
    """profile_device.op_counts: what the host issues per enumerate_batch
    call; on the CPU the plain versions' loops, no kernel launch."""
    from brisk_tpu_torch import profile_device
    rows = profile_device.op_counts(torch.device("cpu"), batch=4, length=64)
    assert [(r["k"], r["windowed"]) for r in rows] == [(31, True),
                                                       (63, False)]
    assert all(r["torch_ops"] > 1000 and r["kernel_launches"] == {}
               for r in rows)
