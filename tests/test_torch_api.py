"""The slice end to end on the CPU: the port's Brisk(device="cpu")
against brisk_tpu.api.Brisk on the same inputs — counts, stats, every
repair/overflow counter, point lookups, query_file — plus a JAX
checkpoint loaded into the port. Exact comparisons throughout."""

import random

import numpy as np
import pytest
import torch

from brisk_tpu.api import Brisk as JBrisk
from brisk_tpu.index import sklstore as j_skl
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch.api import Brisk as TBrisk
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters

torch.set_num_threads(2)

K, M, B = 31, 11, 8
COUNTERS = ("n_emitted", "n_superkmers", "n_repaired_windows",
            "n_repair_batches", "n_skl_overflows", "n_degraded_windows")


def _repair_fixture(path):
    """A record whose windows need exact repairs (equal-hash minimizer
    ties across window seams) and whose poly-A run overflows one lane's
    row budget at batch=16, window=64."""
    random.seed(5)

    def rs(n):
        return "".join(random.choice("ACGT") for _ in range(n))

    rec = (rs(300) + "ACGTTGCA" * 200 + rs(300) + "AAAAAAAAAAAAC" * 80
           + rs(300))
    path.write_text(">repair\n" + rec + "\n")
    return str(path)


@pytest.fixture(scope="module", params=["test", "debug_test", "repair"])
def pair(request, tmp_path_factory):
    if request.param == "repair":
        path = _repair_fixture(tmp_path_factory.mktemp("fx") / "repair.fa")
    else:
        path = f"data/{request.param}.fa"
    jb = JBrisk(JParameters(K, M, B), batch=16, window=64)
    jb.insert_file(path)
    tb = TBrisk(Parameters(K, M, B), batch=16, window=64, device="cpu")
    tb.insert_file(path)
    return request.param, path, jb, tb


def test_counts_stats_and_counters(pair):
    name, path, jb, tb = pair
    jd, td = jb.counts_dict(), tb.counts_dict()
    assert td == jd
    assert td == pyref.count_fasta(path, K, M)
    assert tb.stats() == jb.stats()
    assert tb.skl_stats() == jb.skl_stats()
    for c in COUNTERS:
        assert getattr(tb, c) == getattr(jb, c), c
    if name == "repair":  # the fixture must exercise the repair paths
        assert jb.n_repaired_windows > 0 and jb.n_repair_batches > 0
        assert jb.n_skl_overflows > 0


def test_get_many_and_query_file(pair):
    name, path, jb, tb = pair
    rng = np.random.default_rng(1)
    kmers = sorted(tb.counts_dict())
    sample = [pyref.num2str(kmers[int(i)], K)
              for i in rng.integers(0, len(kmers), 60)]
    sample += ["ACGT" * 7 + "ACG"]  # most likely absent
    assert tb.get_many(sample) == jb.get_many(sample)
    assert tb.get_canonical(sample[0]) == jb.get_canonical(sample[0])
    # the reference join against a query arena whose flushes were all
    # retired (repairs and overflow re-runs included)
    shadow = JBrisk(JParameters(K, M, B), batch=16, window=64)
    shadow.insert_file(path)
    shadow._drain()
    jb._ensure_final()
    want = j_skl.query_join_total(jb.skl, [shadow.skl], K, M, B)
    assert tb.query_file(path) == want
    if name != "repair":
        # brisk_tpu's own query_file agrees where no query window repairs
        assert want == jb.query_file(path)


def test_jax_checkpoint_loads_into_port(tmp_path):
    path = "data/test.fa"
    jb = JBrisk(JParameters(K, M, B), batch=16, window=64)
    jb.insert_file(path)
    ckpt = str(tmp_path / "idx.npz")
    jb.save(ckpt)
    tb = TBrisk.load(ckpt, batch=16, window=64, device="cpu")
    assert tb.counts_dict() == jb.counts_dict()
    kmers = [pyref.num2str(v, K) for v in sorted(jb.counts_dict())[:50]]
    assert tb.get_many(kmers) == jb.get_many(kmers)
    assert tb.n_emitted == jb.n_emitted
    assert tb.stats() == jb.stats()


def test_unported_entry_points_raise(tmp_path):
    """The entry points the first slice left out now run (k > 32 insert,
    consolidate, reallocate, save), and the payload API and the sharded
    facade import."""
    import importlib
    seq = "ACGTTGCAACGGATTC" * 12
    tb = TBrisk(Parameters(63, 21, 14), batch=4, window=128, device="cpu")
    tb.insert_sequence(seq)
    want = {}
    pyref.count_sequence(want, seq, 63, 21, pyref.get_decycling(21))
    assert tb.counts_dict() == want
    tb = TBrisk(Parameters(K, M, B), batch=4, window=64, device="cpu")
    tb.insert_sequence("ACGTTGCAAC" * 20)
    want = tb.counts_dict()
    tb.consolidate()
    tb.reallocate()
    tb.save(str(tmp_path / "idx.npz"))
    assert TBrisk.load(str(tmp_path / "idx.npz"),
                       device="cpu").counts_dict() == want
    assert importlib.import_module("brisk_tpu_torch.data_api").BriskData
    assert importlib.import_module(
        "brisk_tpu_torch.parallel.facade").ShardedBrisk


def test_segmented_finalize_matches_oracle():
    """Mid-ingest finalizes: every flush closes a bucket-grouped segment
    (finalize of rows [F, N) with F > 0); counts, the distinct count and
    lookups across the segments equal the one-segment index and the
    oracle."""
    path = "data/debug_test.fa"
    seg = TBrisk(Parameters(K, M, B), batch=16, window=64, device="cpu")
    seg.segment_rows = 1500
    seg.insert_file(path)
    seg.finalize()
    one = TBrisk(Parameters(K, M, B), batch=16, window=64, device="cpu")
    one.insert_file(path)
    assert len(seg._skl_segments) > 2 and len(one._skl_segments) == 0
    assert seg.counts_dict() == pyref.count_fasta(path, K, M)
    assert seg.stats()["nb_kmers"] == one.stats()["nb_kmers"]
    kmers = [pyref.num2str(v, K) for v in sorted(seg.counts_dict())[::97]]
    assert seg.get_many(kmers) == one.get_many(kmers)


def test_synthetic_reads_with_n_runs_match_oracle(tmp_path):
    """Records split at N runs into several chunks (the reference's
    clean_dna loop) and many short records per flush."""
    from tests.make_synth_fasta import write_synth
    path = str(tmp_path / "synth.fa")
    write_synth(path, 30_000, read_len=700, seed=3)
    tb = TBrisk(Parameters(K, M, B), batch=16, window=64, device="cpu")
    tb.insert_file(path)
    want = pyref.count_fasta(path, K, M)
    assert tb.counts_dict() == want
    assert tb.n_emitted == sum(len(c) - K + 1
                               for c in pyref.read_fasta_chunks(path)
                               if len(c) >= K)


def test_entry_points_default_to_the_card(tmp_path):
    """Brisk(params) and Brisk.load(path) run on the first CUDA card
    unless asked for the host, and raise (no silent CPU index) when
    there is no card; device="cpu" runs on the host."""
    import inspect
    assert inspect.signature(TBrisk).parameters["device"].default == "cuda"
    assert inspect.signature(TBrisk.load).parameters[
        "device"].default == "cuda"
    tb = TBrisk(Parameters(K, M, B), batch=4, window=64, device="cpu")
    tb.insert_sequence("ACGTTGCAAC" * 20)
    tb.save(str(tmp_path / "idx.npz"))
    assert tb.skl.bucket.device.type == "cpu"
    if torch.cuda.is_available():
        assert TBrisk(Parameters(K, M, B)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TBrisk(Parameters(K, M, B))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TBrisk.load(str(tmp_path / "idx.npz"))
    back = TBrisk.load(str(tmp_path / "idx.npz"), device="cpu")
    assert back.counts_dict() == tb.counts_dict()
