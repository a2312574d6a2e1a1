"""data_api.BriskData of the port (device="cpu") against
brisk_tpu.data_api.BriskData on the same inputs: the payload state
(keys, lanes, n_sorted, n_used), n_emitted and n_repaired_windows equal
after every step — the scenarios of tests/test_payload.py, insert_file on
the fixtures (one that repairs), k = 63, update, reallocate and .npz
checkpoints crossing between the packages. Exact comparisons throughout.
"""

import inspect

import numpy as np
import pytest
import torch

from brisk_tpu.data_api import BriskData as JData
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch.api import Brisk as TBrisk
from brisk_tpu_torch.data_api import BriskData as TData
from brisk_tpu_torch.index import payload
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters
from tests.test_torch_api import _repair_fixture

torch.set_num_threads(2)

K, M, B = 31, 11, 8
FILE_GEOMETRY = dict(batch=16, window=64, stack=2)


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def make_pair(k, m, b, **kw):
    return (JData(JParameters(k, m, b), **kw),
            TData(Parameters(k, m, b), device="cpu", **kw))


def assert_same(jb, tb):
    """State arrays, counters, parameters and kinds equal."""
    got = payload.to_numpy(tb.state)
    assert (got["n_sorted"], got["n_used"]) == (int(jb.state.n_sorted),
                                                int(jb.state.n_used))
    np.testing.assert_array_equal(got["keys"], np.asarray(jb.state.keys))
    np.testing.assert_array_equal(got["data"], np.asarray(jb.state.data))
    assert (tb.n_emitted, tb.n_repaired_windows) == (jb.n_emitted,
                                                     jb.n_repaired_windows)
    p, q = tb.params, jb.params
    assert (p.k, p.m, p.b) == (q.k, q.m, q.b)
    assert tb.kinds == jb.kinds


def expected_payload(seq, k, m):
    """value -> (count, last_pos, first_pos) from the oracle scan."""
    dede = pyref.DecyclingSet(m)
    exp = {}
    for i, (rec, _, _) in enumerate(pyref.scan_emissions(seq, k, m, dede)):
        c, lp, fp = exp.get(rec.kmer, (0, 0, 1 << 62))
        exp[rec.kmer] = (c + 1, max(lp, i), min(fp, i))
    return exp


def gets(bd, kmers):
    return [bd.get(s) for s in kmers]


@pytest.fixture(scope="module", params=["test", "debug_test", "repair"])
def filepair(request, tmp_path_factory):
    if request.param == "repair":
        path = _repair_fixture(tmp_path_factory.mktemp("fx") / "repair.fa")
    else:
        path = f"data/{request.param}.fa"
    jb, tb = make_pair(K, M, B, width=2, **FILE_GEOMETRY)
    jb.insert_file(path)
    tb.insert_file(path)
    return request.param, path, jb, tb


def test_insert_file_matches(filepair):
    """The log after insert_file (uncompacted), then items() and the
    compacted state."""
    name, path, jb, tb = filepair
    assert_same(jb, tb)
    assert tb.state.n_used > tb.state.n_sorted
    assert list(tb.items()) == list(jb.items())
    assert_same(jb, tb)
    assert tb.n_emitted == sum(len(c) - K + 1
                               for c in pyref.read_fasta_chunks(path)
                               if len(c) >= K)
    if name == "repair":  # the fixture must exercise the repair route
        assert jb.n_repaired_windows > 0


def test_get_matches_and_agrees_with_the_counter(filepair):
    """get() on stored k-mers (both orientations) and absent ones; the
    distinct count and lane 0 mod 256 equal the counter's on the file."""
    name, path, jb, tb = filepair
    rng = np.random.default_rng(len(name))
    kv = sorted(kv for kv, _ in tb.items())
    sample = [pyref.num2str(kv[int(i)], K)
              for i in rng.integers(0, len(kv), 40)]
    sample += [pyref.num2str(pyref.revcomp(pyref.str2num(s), K), K)
               for s in sample[:10]]
    sample += ["ACGT" * 7 + "ACG"]
    got = gets(tb, sample)
    assert got == gets(jb, sample)
    counter = TBrisk(Parameters(K, M, B), device="cpu", **FILE_GEOMETRY)
    counter.insert_file(path)
    assert tb.state.n_sorted == counter.stats()["nb_kmers"]
    want = counter.get_many(sample)
    assert [None if g is None else g[0] % 256 for g in got] == want
    lane0 = payload.to_numpy(tb.state)["data"][0, :tb.state.n_sorted]
    assert int(lane0.sum(dtype=np.int64)) == tb.n_emitted


def test_count_last_first_position():
    """width-3 (count, last-pos, first-pos) with forced k-mer repeats."""
    rng = np.random.default_rng(5)
    core = rand_seq(rng, 120)
    seq = core + rand_seq(rng, 60) + core
    jb, tb = make_pair(K, M, B, width=3, kinds=("sum", "max", "min"))
    jb.insert_sequence(seq)
    tb.insert_sequence(seq)
    assert_same(jb, tb)
    items = dict(tb.items())
    assert items == dict(jb.items())
    assert_same(jb, tb)
    exp = expected_payload(seq, K, M)
    assert set(items) <= set(exp)
    assert any(c > 1 for c, _, _ in items.values())
    s = core[:K]
    rc = pyref.num2str(pyref.revcomp(pyref.str2num(s), K), K)
    assert gets(tb, [s, rc]) == gets(jb, [s, rc])


def test_update_reallocate_and_checkpoints_cross(tmp_path):
    """update of an existing and a new k-mer, reallocate, and .npz files
    loaded by the other package, state-equal after each step."""
    rng = np.random.default_rng(6)
    seq = rand_seq(rng, 100)
    jb, tb = make_pair(K, M, B, width=2, kinds=("sum", "max"))
    jb.insert_sequence(seq)
    tb.insert_sequence(seq)
    s_old = seq[:K]
    target = s_old if tb.get(s_old) else pyref.num2str(
        pyref.revcomp(pyref.str2num(s_old), K), K)
    s_new = "ACGT" * 7 + "ACG"
    vals = np.array([[5, 7], [10_000, 0xFFFFFFF0]], np.uint32)
    before = tb.get(target)
    for bd in (jb, tb):
        bd.update([target, s_new], vals)
    assert_same(jb, tb)
    assert tb.get(target) == (before[0] + 5, max(before[1], 10_000))
    assert tb.get(s_new) == jb.get(s_new) == (7, 0xFFFFFFF0)
    assert_same(jb, tb)
    agg = sorted(tb.items())
    for bd in (jb, tb):
        bd.reallocate()
    assert_same(jb, tb)
    assert tb.params.m == M + 2 and sorted(tb.items()) == agg

    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jb.save(jpath)
    tb.save(tpath)
    t_from_j = TData.load(jpath, device="cpu")
    j_from_t = JData.load(tpath)
    assert_same(jb, t_from_j)
    assert_same(j_from_t, tb)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)
            assert zt[f].dtype == zj[f].dtype, f
    assert t_from_j.get(s_new) == j_from_t.get(s_new) == (7, 0xFFFFFFF0)


def test_long_sequence_multibatch():
    """Several window flushes of one sequence, (count, last position)."""
    rng = np.random.default_rng(7)
    seq = rand_seq(rng, 1500)
    jb, tb = make_pair(K, M, B, width=2)
    jb.insert_sequence(seq)
    tb.insert_sequence(seq)
    assert_same(jb, tb)
    got = dict(tb.items())
    assert got == dict(jb.items())
    exp = {kv: (c, lp) for kv, (c, lp, _) in
           expected_payload(seq, K, M).items()}
    assert got == exp


def test_windowed_records(tmp_path):
    """Three records (one shorter than two windows, one shorter than a
    window) through insert_file's windowed pipeline."""
    rng = np.random.default_rng(31)
    records = [rand_seq(rng, n) for n in (900, 45, 2200)]
    path = tmp_path / "in.fa"
    path.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(records)))
    jb, tb = make_pair(K, M, B, width=2, batch=8, window=64, stack=2)
    jb.insert_file(str(path))
    tb.insert_file(str(path))
    assert_same(jb, tb)
    got = dict(tb.items())
    assert got == dict(jb.items())
    exp = {}
    dede = pyref.DecyclingSet(M)
    for rec in records:
        for pos, (r, _, _) in enumerate(pyref.scan_emissions(rec, K, M,
                                                             dede)):
            c, p = exp.get(r.kmer, (0, -1))
            exp[r.kmer] = (c + 1, max(p, pos))
    assert got == exp
    assert tb.n_emitted == sum(len(r) - K + 1 for r in records)


def test_update_defers_compaction():
    """update() appends without compacting; reads see the merged lanes."""
    rng = np.random.default_rng(8)
    seq = rand_seq(rng, 400)
    jb, tb = make_pair(21, 9, 6, width=2, batch=8, window=64)
    jb.insert_sequence(seq)
    tb.insert_sequence(seq)
    kmer = next(seq[i:i + 21] for i in range(0, len(seq) - 21, 3)
                if tb.get(seq[i:i + 21]) is not None)
    before = tb.get(kmer)
    assert before == jb.get(kmer)
    for i in range(5):
        v = np.array([[7], [100 + i]], dtype=np.uint32)
        jb.update([kmer], v)
        tb.update([kmer], v)
        assert_same(jb, tb)
    assert tb.state.n_used > tb.state.n_sorted
    after = tb.get(kmer)
    assert after == jb.get(kmer) == (before[0] + 35, 104)
    assert_same(jb, tb)


def test_insert_sequence_with_extra():
    """Caller-given lanes 1.. (values on both sides of 2^31) through the
    streaming-carry route, several batches."""
    rng = np.random.default_rng(9)
    seq = rand_seq(rng, 700)
    n_k = len(seq) - K + 1
    extra = rng.integers(0, 1 << 32, (2, n_k), dtype=np.uint64
                         ).astype(np.uint32)
    jb, tb = make_pair(K, M, B, width=3, kinds=("sum", "max", "min"))
    jb.insert_sequence(seq, extra=extra)
    tb.insert_sequence(seq, extra=extra)
    assert_same(jb, tb)
    assert list(tb.items()) == list(jb.items())
    assert_same(jb, tb)
    with pytest.raises(ValueError):
        tb.insert_sequence(seq, extra=extra[:, 1:])


def test_k63_insert_update_reallocate(tmp_path):
    """k = 63: the truncation quirk starves the windowed certificate, so
    windows go through the batched repair route."""
    k, m, b = 63, 21, 14
    rng = np.random.default_rng(63)
    path = tmp_path / "k63.fa"
    path.write_text(f">a\n{rand_seq(rng, 2500)}\n>b\n{rand_seq(rng, 700)}\n")
    jb, tb = make_pair(k, m, b, width=2, batch=16, window=128, stack=2)
    jb.insert_file(str(path))
    tb.insert_file(str(path))
    assert_same(jb, tb)
    assert tb.n_repaired_windows > 0
    kv = [pyref.num2str(v, k) for v, _ in list(tb.items())[::300]]
    assert gets(tb, kv) == gets(jb, kv)
    vals = np.array([[1] * len(kv), list(range(len(kv)))], np.uint32)
    for bd in (jb, tb):
        bd.update(kv, vals)
    assert_same(jb, tb)
    for bd in (jb, tb):
        bd.reallocate()
    assert_same(jb, tb)


def test_entry_point_defaults_to_the_card(tmp_path):
    """BriskData(params) and BriskData.load(path) run on the first CUDA
    card unless asked for the host, and raise when there is none."""
    assert inspect.signature(TData).parameters["device"].default == "cuda"
    assert inspect.signature(TData.load).parameters[
        "device"].default == "cuda"
    tb = TData(Parameters(K, M, B), device="cpu")
    tb.insert_sequence("ACGTTGCAAC" * 20)
    tb.save(str(tmp_path / "pl.npz"))
    assert tb.state.keys.device.type == "cpu"
    if torch.cuda.is_available():
        assert TData(Parameters(K, M, B)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TData(Parameters(K, M, B))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TData.load(str(tmp_path / "pl.npz"))
