"""The k > 32 streaming insert of the port against brisk_tpu on the CPU:
the io.fasta copy, the streaming insert program, and Brisk at k=63
(insert_sequence, insert_file through the long-record and the short-read
routes, finalize, reads, counters, query_file). Exact comparisons."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.api import Brisk as JBrisk
from brisk_tpu.index import pipeline as j_pipe
from brisk_tpu.index import sklstore as j_skl
from brisk_tpu.io import fasta as j_fasta
from brisk_tpu.ops import enumerate as j_enum
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch import _u32
from brisk_tpu_torch.api import Brisk as TBrisk
from brisk_tpu_torch.index import pipeline as t_pipe
from brisk_tpu_torch.index import sklstore as t_skl
from brisk_tpu_torch.io import fasta as t_fasta
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.ops import enumerate as t_enum
from brisk_tpu_torch.params import Parameters

torch.set_num_threads(2)

K, M, B = 63, 21, 14
GEOM = dict(batch=16, window=128, stack=2)
COUNTERS = ("n_emitted", "n_superkmers", "n_repaired_windows",
            "n_repair_batches", "n_skl_overflows", "n_degraded_windows")


def _rand_seq(rng, n):
    return "".join(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
                   .tobytes().decode())


def _write_fasta(path, seqs):
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    return str(path)


def _arena(state):
    """Host copy of the used rows of an arena (either package)."""
    n = int(state.n_rows)
    s_max = t_skl.skl_dims(K, M, B)[1]
    if isinstance(state, t_skl.SklState):
        cols = t_skl.to_numpy(state)
    else:
        cols = {f: np.asarray(getattr(state, f))
                for f in ("bucket", "meta", "nucs", "data", "offs")}
    return dict(n_rows=n, n_fin_rows=int(state.n_fin_rows),
                n_fin_kmers=int(state.n_fin_kmers),
                bucket=cols["bucket"][:n], meta=cols["meta"][:n],
                nucs=cols["nucs"][:, :n], offs=cols["offs"][:n],
                data=cols["data"][:n * s_max])


def _assert_arena(ja, ta, fin):
    assert ta["n_rows"] == ja["n_rows"] > 0
    fields = ["bucket", "meta", "nucs"]
    if fin:
        fields += ["offs", "data"]
        assert (ta["n_fin_rows"], ta["n_fin_kmers"]) == (
            ja["n_fin_rows"], ja["n_fin_kmers"])
    for f in fields:
        np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)


@pytest.fixture(scope="module", params=["sequence", "file", "short_reads"])
def built(request, tmp_path_factory):
    """Both packages' k=63 indexes after one ingest, with the arenas as
    they stood before the first finalize."""
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("k63")
    jb = JBrisk(JParameters(K, M, B), **GEOM)
    tb = TBrisk(Parameters(K, M, B), device="cpu", **GEOM)
    if request.param == "sequence":
        # the 40-base record is shorter than k and counts nothing
        seqs = [_rand_seq(rng, 400), _rand_seq(rng, 70), _rand_seq(rng, 40)]
        path = _write_fasta(tmp / "seqs.fa", seqs)
        for s in seqs:
            jb.insert_sequence(s)
            tb.insert_sequence(s)
    else:
        if request.param == "file":
            path = "data/test.fa"
        else:
            # 150 bp reads with one 400 bp record: the short-read fast
            # path with its BatchPacker tail for records longer than a lane
            seqs = [_rand_seq(rng, 150) for _ in range(40)]
            seqs.insert(7, _rand_seq(rng, 400))
            path = _write_fasta(tmp / "reads.fa", seqs)
            geo = tb._stream_geometry(150)
            assert geo.l_new == 128 and 150 <= geo.l_buf < 400
        jb.insert_file(path)
        tb.insert_file(path)
        jb._drain()
        tb._drain()
    return dict(name=request.param, path=path, jb=jb, tb=tb,
                j_ins=_arena(jb.skl), t_ins=_arena(tb.skl))


def test_stream_index_matches_jax(built):
    jb, tb = built["jb"], built["tb"]
    _assert_arena(built["j_ins"], built["t_ins"], fin=False)
    assert tb.counts_dict() == jb.counts_dict()
    if built["name"] != "sequence":
        assert tb.counts_dict() == pyref.count_fasta(built["path"], K, M)
    _assert_arena(_arena(jb.skl), _arena(tb.skl), fin=True)
    assert tb.stats() == jb.stats()
    assert tb.skl_stats() == jb.skl_stats()
    for c in COUNTERS:
        assert getattr(tb, c) == getattr(jb, c), c
    assert tb.n_repaired_windows == 0


def test_stream_query_file_matches_jax(built):
    jb, tb, path = built["jb"], built["tb"], built["path"]
    total = tb.query_file(path)
    assert total == jb.query_file(path)
    assert total > 0


def test_insert_stream_sklnative_matches():
    """The streaming program over three flushes of small batches: records
    stream across batches and flushes (carry), records shorter than k
    are dropped by the packer, the tail is padded with empty lanes.
    Every output and the arena after insert and after finalize match."""
    rng = np.random.default_rng(5)
    recs = [_rand_seq(rng, n) for n in (700, 30, 90, 62, 63, 250, 500,
                                        10, 140, 333, 64, 900)]
    S, BATCH, L_NEW = 2, 4, 64
    packer = j_fasta.BatchPacker(K, BATCH, L_NEW)
    batches = list(packer.pack(iter(recs)))
    assert len(batches) > 2 * S
    while len(batches) % S:
        batches.append(j_fasta.Batch(
            np.zeros((BATCH, packer.l_buf), np.uint8),
            np.ones(BATCH, bool), np.zeros(BATCH, np.int32), 0))
    nw = j_skl.skl_dims(K, M, B)[3]
    js = j_skl.empty(1 << 12, 1 << 12, nw)
    ts = t_skl.empty(1 << 12, 1 << 12, nw, "cpu")
    jc, tc = j_enum.zero_carry(BATCH), t_enum.zero_carry(BATCH)
    for f0 in range(0, len(batches), S):
        group = batches[f0:f0 + S]
        codes, fresh, ve = (np.stack([getattr(bt, f) for bt in group])
                            for f in ("codes", "fresh", "valid_end"))
        jo = j_pipe.insert_stream_sklnative(
            js, jnp.asarray(codes), jnp.asarray(fresh), jnp.asarray(ve), jc,
            k=K, m=M, b=B, row_cap=L_NEW)
        to = t_pipe.insert_stream_sklnative(
            ts, torch.from_numpy(codes), torch.from_numpy(fresh),
            torch.from_numpy(ve), tc, K, M, B, L_NEW)
        for i in (1, 2, 4):  # n_sk, n_km, n_rows_after
            assert int(to[i]) == int(jo[i]), i
        for a, c in zip(jo[3], to[3]):  # the carry
            np.testing.assert_array_equal(c.numpy().astype(np.int64),
                                          np.asarray(a).astype(np.int64))
        js, jc, ts, tc = jo[0], jo[3], to[0], to[3]
    _assert_arena(_arena(js), _arena(ts), fin=False)
    _assert_arena(_arena(j_skl.finalize_device(js, K, M, B)),
                  _arena(t_skl.finalize_device(ts, K, M, B)), fin=True)


def test_fasta_copy_matches():
    rng = np.random.default_rng(8)
    recs = [_rand_seq(rng, n) for n in (300, 20, 150, 62, 1000, 75)]
    recs[2] = t_fasta.chunk_codes(recs[2])  # a pre-encoded record too
    np.testing.assert_array_equal(t_fasta.chunk_codes(recs[0]),
                                  j_fasta.chunk_codes(recs[0]))
    for k, batch, l_new in ((63, 4, 64), (31, 3, 100)):
        jbs = list(j_fasta.BatchPacker(k, batch, l_new).pack(iter(recs)))
        tbs = list(t_fasta.BatchPacker(k, batch, l_new).pack(iter(recs)))
        assert len(jbs) == len(tbs) > 2
        for a, c in zip(jbs, tbs):
            for f in ("codes", "fresh", "valid_end"):
                np.testing.assert_array_equal(getattr(c, f), getattr(a, f))
            assert c.n_kmers == a.n_kmers
    jbs = list(j_fasta.fasta_batches("data/test.fa", K, 8, 128))
    tbs = list(t_fasta.fasta_batches("data/test.fa", K, 8, 128))
    assert len(jbs) == len(tbs) > 1
    for a, c in zip(jbs, tbs):
        np.testing.assert_array_equal(c.codes, a.codes)
        np.testing.assert_array_equal(c.valid_end, a.valid_end)
