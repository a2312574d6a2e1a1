"""Parity of the PyTorch port's ops (brisk_tpu_torch.ops) with the JAX
package on the CPU: the same numpy inputs, made from a seed, go through
both; every comparison is exact (integer data, tolerance 0)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.ops import codec as j_codec
from brisk_tpu.ops import enumerate as j_enum
from brisk_tpu.ops import hashing as j_hashing
from brisk_tpu.ops import minimizer as j_min
from brisk_tpu.ops import revcomp as j_rc
from brisk_tpu.ops import u128 as j_u128
from brisk_tpu.oracle import pyref as j_pyref
from brisk_tpu_torch.ops import codec as t_codec
from brisk_tpu_torch.ops import decycling as t_dec
from brisk_tpu_torch.ops import enumerate as t_enum
from brisk_tpu_torch.ops import hashing as t_hashing
from brisk_tpu_torch.ops import minimizer as t_min
from brisk_tpu_torch.ops import revcomp as t_rc
from brisk_tpu_torch.ops import u128 as t_u128

torch.set_num_threads(2)


def _limbs(rng, n, shape=(257,)):
    return [rng.integers(0, 1 << 32, shape, dtype=np.uint32)
            for _ in range(n)]


def _j(limbs):
    return tuple(jnp.asarray(x) for x in limbs)


def _t(limbs):
    return tuple(torch.from_numpy(x.astype(np.int64)) for x in limbs)


def _eq(a, b):
    """Exact equality of a JAX value (or tuple) and a torch one."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  b.numpy().astype(np.int64))


@pytest.mark.parametrize("n", [2, 4])
def test_u128_shifts_and_arith(n):
    rng = np.random.default_rng(n)
    a, b = _limbs(rng, n), _limbs(rng, n)
    a[0][:8] = 0xFFFFFFFF  # carries through every limb
    s = rng.integers(0, 32 * n + 12, 257).astype(np.uint32)
    s[:4] = [0, 32, 64, 32 * n]
    ja, jb, ta, tb = _j(a), _j(b), _t(a), _t(b)
    js, ts = jnp.asarray(s), torch.from_numpy(s.astype(np.int64))
    _eq(j_u128.shl_var(ja, js), t_u128.shl_var(ta, ts))
    _eq(j_u128.shr_var(ja, js), t_u128.shr_var(ta, ts))
    for st in (0, 1, 8, 31, 32, 45, 64, 100):
        _eq(j_u128.shl(ja, st), t_u128.shl(ta, st))
        _eq(j_u128.shr(ja, st), t_u128.shr(ta, st))
        _eq(j_u128.mask_bits(ja, st), t_u128.mask_bits(ta, st))
    _eq(j_u128.add(ja, jb), t_u128.add(ta, tb))
    _eq(j_u128.bnot(ja), t_u128.bnot(ta))
    _eq(j_u128.lt(ja, jb), t_u128.lt(ta, tb))
    _eq(j_u128.le(ja, ja), t_u128.le(ta, ta))
    _eq(j_u128.minimum(ja, jb), t_u128.minimum(ta, tb))


@pytest.mark.parametrize("k,m", [(31, 11), (63, 21), (21, 9)])
def test_codec_revcomp_hashing(k, m):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (3, 97), dtype=np.uint32)
    jw = j_codec.kmer_windows(jnp.asarray(codes), k, m)
    tw = t_codec.kmer_windows(torch.from_numpy(codes.astype(np.int64)), k, m)
    _eq(jw, tw)
    lo, hi = _limbs(rng, 2)
    hi &= (1 << max(0, 2 * m - 32)) - 1
    jl, th = _j([lo, hi]), _t([lo, hi])
    _eq(j_rc.rcb64(*jl, m), t_rc.rcb64(*th, m))
    _eq(j_rc.canonize64(*jl, m), t_rc.canonize64(*th, m))
    k4 = _limbs(rng, 4)
    _eq(j_rc.rcb128_broken(_j(k4), k), t_rc.rcb128_broken(_t(k4), k))
    _eq(j_rc.canonized_k(_j(k4), k), t_rc.canonized_k(_t(k4), k))
    _eq(j_hashing.mix_key(*jl, m), t_hashing.mix_key(*th, m))
    _eq(j_hashing.bfc_hash(*jl, m), t_hashing.bfc_hash(*th, m))


@pytest.mark.parametrize("m", [3, 5, 7])
def test_decycling_exhaustive(m):
    """Every m-mer's class equals the reference oracle (float64)."""
    seq = np.arange(4 ** m, dtype=np.int64)
    got = t_dec.mem_double(torch.from_numpy(seq & 0xFFFFFFFF),
                           torch.from_numpy(seq >> 32), m).numpy()
    dede = j_pyref.DecyclingSet(m)
    want = np.array([dede.mem_double(int(x)) for x in seq])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [11, 21])
def test_decycling_sampled(m):
    rng = np.random.default_rng(m)
    seq = rng.integers(0, 1 << (2 * m), 3000, dtype=np.int64)
    got = t_dec.mem_double(torch.from_numpy(seq & 0xFFFFFFFF),
                           torch.from_numpy(seq >> 32), m).numpy()
    dede = j_pyref.DecyclingSet(m)
    np.testing.assert_array_equal(
        got, [dede.mem_double(int(x)) for x in seq])


@pytest.mark.parametrize("k,m", [(31, 11), (63, 21)])
def test_position_pipeline_and_rescan(k, m):
    rng = np.random.default_rng(k + m)
    codes = rng.integers(0, 4, (4, 110), dtype=np.uint32)
    codes[1, 20:70] = 0  # poly-A: equal-hash ties
    codes[2, 10:90] = np.tile([0, 1, 3, 2], 20)
    jpa = j_min.position_pipeline(jnp.asarray(codes), k, m)
    tpa = t_min.position_pipeline(torch.from_numpy(codes.astype(np.int64)),
                                  k, m)
    _eq(tuple(jpa), tuple(tpa))
    with_unique = k <= 32
    jr = j_min.windowed_get_minimizer(jpa, jpa.fwd_k, k, m,
                                      with_unique=with_unique)
    tr = t_min.windowed_get_minimizer(tpa, tpa.fwd_k, k, m,
                                      with_unique=with_unique)
    if with_unique:
        _eq(jr[1], tr[1])
        jr, tr = jr[0], tr[0]
    _eq(tuple(jr), tuple(tr))


def _enum_inputs(k, B=6, L=130, seed=0):
    rng = np.random.default_rng(seed + k)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    codes[0, 30:90] = 0
    codes[1, 5:125] = np.tile([0, 1, 3, 2, 2, 3, 1, 0], 15)
    ve = rng.integers(k, L + 1, B).astype(np.int32)
    vs = np.full(B, k - 1 + 12, np.int32)
    vs[0] = k - 1
    fresh = np.ones(B, bool)
    fresh[2] = False
    carry = [rng.integers(0, 8, B).astype(np.uint32) for _ in range(7)]
    carry[3] = carry[3] % 2 == 0
    return codes, fresh, ve, vs, carry


@pytest.mark.parametrize("k,m,b,windowed", [
    (31, 11, 8, False), (31, 11, 8, True), (21, 9, 6, True),
    (63, 21, 14, False)])
def test_enumerate_batch_all_fields(k, m, b, windowed):
    codes, fresh, ve, vs, carry = _enum_inputs(k)
    jcarry = j_enum.MinimizerState(*(jnp.asarray(c) for c in carry))
    tcarry = t_enum.MinimizerState(*(torch.from_numpy(
        c if c.dtype == bool else c.astype(np.int64)) for c in carry))
    jem, jfin = j_enum.enumerate_batch(
        jnp.asarray(codes), jnp.asarray(fresh), jnp.asarray(ve), jcarry,
        k=k, m=m, b=b, valid_start=jnp.asarray(vs) if windowed else None)
    tem, tfin = t_enum.enumerate_batch(
        torch.from_numpy(codes), torch.from_numpy(fresh),
        torch.from_numpy(ve), tcarry, k, m, b,
        valid_start=torch.from_numpy(vs) if windowed else None)
    for f in j_enum.Emissions._fields:
        a, c = getattr(jem, f), getattr(tem, f)
        if f == "replay":
            _eq(tuple(a), tuple(c))
        else:
            _eq(a, c)
    _eq(tuple(jfin), tuple(tfin))
    assert bool(tem.valid.any()) and bool(tem.boundary.any())


def test_pack_hash_orders_like_uint64():
    vals = [(h, hi, lo) for h, hi, lo in itertools.product(
        (0, 1, 2), (0, 5, (1 << 30) - 1), (0, 7, 0xFFFFFFFF))]
    heavy, hi, lo = (torch.tensor(x) for x in zip(*vals))
    packed = t_hashing.pack_hash(heavy, hi, lo)
    want = [(h << 62) + (a << 32) + c for h, a, c in vals]
    assert np.argsort(packed.numpy(), kind="stable").tolist() == \
        np.argsort(np.array(want, dtype=np.uint64), kind="stable").tolist()
    for x, y in zip(t_hashing.unpack_hash(packed), (heavy, hi, lo)):
        assert torch.equal(x, y)
