"""The sharded facade on the CPU: the port's ShardedBrisk (device="cpu",
8 shards in one process) against brisk_tpu's ShardedBrisk on the 8-device
CPU mesh of tests/conftest.py, on the same FASTA files — here the five
scenarios of tests/test_facade.py; tests/test_torch_facade_repair.py runs
the same checks on inputs that need repairs. Compared: every per-shard
arena array after insert_file and after finalize, the host counters,
counts_dict (and the oracle), stats, skl_stats, get / get_canonical,
query_file (against brisk_tpu's facade and the port's Brisk), KFF
read-back, reallocate and .npz files crossing both ways. Exact
comparisons throughout."""

import random

import numpy as np
import pytest
import torch

from brisk_tpu.parallel import sharded as j_sharded
from brisk_tpu.parallel.facade import ShardedBrisk as JSharded
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch import _u32
from brisk_tpu_torch.api import Brisk as TBrisk
from brisk_tpu_torch.io import kff
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters
from brisk_tpu_torch.parallel.facade import ShardedBrisk as TSharded
from tests.test_torch_api import _repair_fixture

torch.set_num_threads(2)

FIELDS = ("bucket", "meta", "nucs", "data", "offs", "n_rows", "n_fin_rows",
          "n_fin_kmers")
COUNTERS = ("n_emitted", "n_superkmers", "n_spilled", "n_repaired_windows",
            "n_skl_overflows")
K31, K63 = (31, 11, 8), (63, 21, 14)
GEO31 = dict(batch_per_shard=8, window=64, stack=2)


def _rand(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _parity(rng):
    """One long chromosome + short reads (windows span every shard)."""
    return [_rand(rng, 4000)] + [_rand(rng, rng.randint(31, 200))
                                 for _ in range(20)]


def _skew(rng):
    """Poly-A-heavy records: a few hot buckets, spills at a tiny cap."""
    return ["".join("A" if rng.random() < 0.9 else rng.choice("CGT")
                    for _ in range(500)) for _ in range(12)]


def _k63(rng):
    return [_rand(rng, rng.randint(63, 300)) for _ in range(12)]


def _kff(rng):
    return [_rand(rng, rng.randint(31, 600)) for _ in range(10)]


def _realloc(rng):
    return [_rand(rng, rng.randint(31, 400)) for _ in range(8)]


# name -> (records, (k, m, b), facade geometry, skl_row_cap override)
SCENARIOS = {
    "parity": (_parity, K31, GEO31, None),
    "skew": (_skew, K31, dict(GEO31, skl_route_cap=2), None),
    "k63": (_k63, K63, dict(batch_per_shard=4, window=64), None),
    "kff": (_kff, K31, GEO31, None),
    "realloc": (_realloc, K31, GEO31, None),
}
# which scenarios (of both files) run the costlier checks
QUERY = ("parity", "k63", "repair31")
KFF = ("kff", "skew", "repair63")
NPZ_REALLOCATE = ("realloc", "repair31", "repair63")


@pytest.fixture(scope="module")
def mesh():
    return j_sharded.make_mesh(8)


def arena_np(br) -> dict:
    """The shard-axis arena of either package as numpy arrays (uint32
    columns, int64 row counters)."""
    out = {}
    for name in FIELDS:
        x = getattr(br.skl, name)
        if isinstance(x, torch.Tensor):
            x = _u32.to_np(x) if x.dtype == torch.int32 else x.numpy()
        x = np.asarray(x)
        out[name] = x.astype(np.int64) if name.startswith("n_") else x
    return out


def assert_same_arena(got: dict, want: dict, step: str) -> None:
    for name in FIELDS:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{step}: {name}")


def build(name, scenario, mesh, tmp):
    """Both facades on one scenario's FASTA, inserted; the arenas are
    copied right after insert_file (any read finalizes)."""
    gen, (k, m, b), geo, row_cap = scenario
    path = str(tmp / "in.fa")
    if gen is None:
        _repair_fixture(tmp / "in.fa")
    else:
        recs = gen(random.Random(23 + sum(map(ord, name))))
        with open(path, "w") as fh:
            fh.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    jb = JSharded(JParameters(k, m, b), mesh=mesh, **geo)
    tb = TSharded(Parameters(k, m, b), n_devices=8, device="cpu", **geo)
    for br in (jb, tb):
        if row_cap:  # fewer row slots per lane: forces overflow lanes
            br.skl_row_cap = row_cap
        br.insert_file(path)
    inserted = (arena_np(jb), arena_np(tb))
    return dict(name=name, path=path, kmb=(k, m, b), geo=geo, jb=jb, tb=tb,
                inserted=inserted, tmp=tmp)


@pytest.fixture(scope="module", params=list(SCENARIOS))
def built(request, mesh, tmp_path_factory):
    name = request.param
    return build(name, SCENARIOS[name], mesh, tmp_path_factory.mktemp(name))


def test_arenas_and_counters(built):
    jb, tb = built["jb"], built["tb"]
    want, got = built["inserted"]
    assert_same_arena(got, want, "after insert_file")
    for c in COUNTERS:
        assert getattr(tb, c) == getattr(jb, c), c
    jb.finalize()
    tb.finalize()
    assert_same_arena(arena_np(tb), arena_np(jb), "after finalize")
    assert tb._skl_segments == jb._skl_segments
    name = built["name"]
    if name == "skew":  # the tiny cap must trigger the spill path
        assert jb.n_spilled > 0
    if name.startswith("repair"):  # the fixture must exercise repairs
        assert jb.n_repaired_windows > 0 and jb.n_skl_overflows > 0


def test_counts_stats_and_gets(built):
    jb, tb, path = built["jb"], built["tb"], built["path"]
    k, m, _ = built["kmb"]
    counts = tb.counts_dict()
    assert counts == jb.counts_dict()
    assert counts == pyref.count_fasta(path, k, m)
    assert tb.stats() == jb.stats()
    assert tb.skl_stats() == jb.skl_stats()
    rng = np.random.default_rng(3)
    keys = sorted(counts)
    sample = [pyref.num2str(keys[int(i)], k)
              for i in rng.integers(0, len(keys), 12)]
    sample.append(("ACGT" * 16)[:k])  # most likely absent
    for s in sample:
        assert tb.get(s) == jb.get(s), s
        assert tb.get_canonical(s) == jb.get_canonical(s), s


def test_query_file(built):
    if built["name"] not in QUERY:
        pytest.skip("query_file is compared on three scenarios")
    jb, tb, path = built["jb"], built["tb"], built["path"]
    k, m, b = built["kmb"]
    total = tb.query_file(path)
    assert total == jb.query_file(path)
    ref = TBrisk(Parameters(k, m, b), batch=16, window=64, device="cpu")
    ref.insert_file(path)
    assert total == ref.query_file(path)


def test_kff_readback(built):
    if built["name"] not in KFF:
        pytest.skip("KFF is compared on three scenarios")
    jb, tb = built["jb"], built["tb"]
    k, m, _ = built["kmb"]
    out_t, out_j = (str(built["tmp"] / f"{w}.kff") for w in "tj")
    tb.write_kff(out_t)
    jb.write_kff(out_j)
    back = kff.read_index(out_t)
    assert back == kff.read_index(out_j)
    assert back[1:] == (k, m)
    assert back[0] == tb.counts_dict()
    with open(out_t, "rb") as a, open(out_j, "rb") as c:
        assert a.read() == c.read()


def test_npz_both_ways_and_reallocate(built, mesh):
    """Each package loads the other's checkpoint to the same arena; then
    reallocate on both loaded copies gives equal arenas and counts."""
    if built["name"] not in NPZ_REALLOCATE:
        pytest.skip("checkpoints and reallocate on three scenarios")
    jb, tb, tmp = built["jb"], built["tb"], built["tmp"]
    ck_t, ck_j = str(tmp / "t.npz"), str(tmp / "j.npz")
    tb.save(ck_t)
    jb.save(ck_j)
    zt, zj = np.load(ck_t), np.load(ck_j)
    assert sorted(zt.files) == sorted(zj.files)
    for f in zj.files:
        assert zt[f].dtype == zj[f].dtype, f
        np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)
    t_from_j = TSharded.load(ck_j, device="cpu", **built["geo"])
    j_from_t = JSharded.load(ck_t, mesh=mesh, **built["geo"])
    assert_same_arena(arena_np(t_from_j), arena_np(j_from_t), "loaded")
    for c in ("n_emitted", "n_superkmers", "n_spilled"):
        assert getattr(t_from_j, c) == getattr(j_from_t, c)
    before = t_from_j.counts_dict()
    t_from_j.reallocate()
    j_from_t.reallocate()
    assert_same_arena(arena_np(t_from_j), arena_np(j_from_t), "reallocate")
    p = t_from_j.params
    assert (p.k, p.m, p.b) == (j_from_t.params.k, j_from_t.params.m,
                               j_from_t.params.b)
    assert t_from_j.counts_dict() == before == j_from_t.counts_dict()
    assert t_from_j.skl_stats() == j_from_t.skl_stats()


def test_entry_point_defaults_to_the_card(tmp_path):
    """ShardedBrisk(params) and ShardedBrisk.load(path) run on the first
    CUDA card unless asked for the host, and raise without one."""
    import inspect
    assert inspect.signature(TSharded).parameters["device"].default \
        == "cuda"
    tb = TSharded(Parameters(*K31), batch_per_shard=2, window=64,
                  device="cpu")
    tb.insert_sequence("ACGTTGCAAC" * 20)
    tb.save(str(tmp_path / "idx.npz"))
    assert tb.skl.bucket.device.type == "cpu" and tb.n_shards == 8
    if torch.cuda.is_available():
        assert TSharded(Parameters(*K31)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TSharded(Parameters(*K31))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TSharded.load(str(tmp_path / "idx.npz"))
    back = TSharded.load(str(tmp_path / "idx.npz"), device="cpu")
    assert back.counts_dict() == tb.counts_dict()
