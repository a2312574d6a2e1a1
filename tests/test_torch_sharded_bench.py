"""The benchmark's sharded cell (k31-chr1-sharded8, traffic module
benchmark/traffic/sharded_count_job.py) on the CPU, through
benchmark/run.py with the look for a card skipped, on a tiny copy of the
cell (8 shards of 32 lanes, a 40 kb genome, 200 query reads): the
module's check gives `correct` true against the plain reference, also
with spills forced by a tiny skl_route_cap, where route_spill_rows reads
above 0; planted faults make `correct` false: in the read-out (one count
altered, one shard's entries dropped) and in the route (every row left
on its source shard, which only owner_gap sees); the query sums a key
split by spills over several shards before its wrap mod 256, as the
reference does; every reader of the cell's metrics but the device
trace's reads a number on a traced run, and the cell's own readers read
nothing on a program without their spans or counters.

tests/conftest.py has imported jax into this process before any run, so
run.main's refusal of forbidden modules is held here to the modules a
run itself loads."""

import copy
import io
import json
import os
import shutil
import sys

import pytest
import torch

from brisk_tpu_torch import spans
from brisk_tpu_torch.index import readout
from brisk_tpu_torch.parallel import sharded
from brisk_tpu_torch.parallel.facade import ShardedBrisk
from brisk_tpu_torch.params import Parameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import program_spans, run, tracing  # noqa: E402
from benchmark.reference import (compare, fasta, keying,  # noqa: E402
                                 kmers)

torch.set_num_threads(2)

CELL = "k31-chr1-sharded8"
TINY_GEOMETRY = dict(batch_per_shard=32, window=64, stack=2)
SPILL_CAP = 2  # skl_route_cap: far below a step's rows per destination
WIDE_CAP = 512  # skl_route_cap: a source shard's rows of a step, all
OWN_METRICS = {"route_spill_rows", "shard_rows_skew", "query_enum_ms"}
SEED = 3000000001
NEW_SPANS = {"query.enumerate", "shard.stack", "deliver"}
NEW_CALLS = {"finalize", "query_file"}


def make_tiny_copy(dst: str) -> str:
    """A checkout-like copy of the benchmark (the port linked in) with
    three tiny cells of the sharded configuration: `tiny`, `tiny-spill`
    (the same at SPILL_CAP) and `tiny-wide` (at WIDE_CAP), each reported
    by the cell's metrics."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(ROOT, "brisk_tpu_torch"),
               os.path.join(dst, "brisk_tpu_torch"))
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    real = run.Cell(ROOT, CELL)
    for name, extra in (("tiny", {}),
                        ("tiny-spill", dict(skl_route_cap=SPILL_CAP)),
                        ("tiny-wide", dict(skl_route_cap=WIDE_CAP))):
        cfg = copy.deepcopy(real.config)
        cfg["name"] = name + "-sharded"
        cfg["geometry"].update(TINY_GEOMETRY, **extra)
        cfg["index_input"].update(bases=40000, n_per=20000)
        wl = copy.deepcopy(real.workload)
        wl.update(name=name, config=cfg["name"])
        wl["traffic"].update(query_reads=200)
        for sub, data in (("configs", cfg), ("workloads", wl)):
            with open(os.path.join(dst, "benchmark", sub,
                                   data["name"] + ".json"), "w") as f:
                json.dump(data, f)
        bench["configs"].append(dict(
            name=cfg["name"], source="a test", reduced=["index_input"],
            file=f"benchmark/configs/{cfg['name']}.json", why="a test"))
        bench["workloads"].append(dict(name=name, config=cfg["name"],
                                       traffic="sharded_count_job",
                                       chips=1, why="a test"))
        for m in bench["per_layer"]:
            if CELL in m["workloads"]:
                m["workloads"].append(name)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dst


@pytest.fixture(scope="module", autouse=True)
def forbidden_if_the_run_loads_them():
    real = run.forbidden_modules
    before = set(real())
    mp = pytest.MonkeyPatch()
    mp.setattr(run, "forbidden_modules",
               lambda: sorted(set(real()) - before))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_copy(str(tmp_path_factory.mktemp("bench")))


def run_cell(root: str, cell: str, trace: int = 0) -> dict:
    out = io.StringIO()
    assert run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                     "0", "--trace", str(trace)], device="cpu", root=root,
                    out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def cell_metrics(source: str = None) -> list:
    """The per-layer metrics the cell reports, of one source if given."""
    return [m["name"] for m in run.Cell(ROOT, CELL).per_layer
            if source in (None, m["source"])]


def host_metrics() -> set:
    """The cell's metrics that a CPU run can read: all but the device
    trace's."""
    return set(cell_metrics()) - set(cell_metrics("device_trace"))


@pytest.fixture(scope="module")
def traced(tiny_root):
    """The spill cell's traced run: (its result line, the trace record
    its readers read, the program's span list at that time)."""
    got = {}
    real = tracing.profiled

    def keep(job, dev):
        res, record = real(job, dev)
        got["record"] = record
        return res, record

    mp = pytest.MonkeyPatch()
    mp.setattr(tracing, "profiled", keep)
    spans.clear()
    try:
        res = run_cell(tiny_root, "tiny-spill", trace=1)
    finally:
        mp.undo()
    recs = spans.records()
    spans.clear()
    return res, got["record"], recs


def test_the_cell_files():
    cell = run.Cell(ROOT, CELL)
    assert cell.chips == 1 and cell.workload["driver"] == "sharded_count_job"
    assert cell.config["reduced"] == []
    assert cell.config["geometry"] == dict(n_shards=8, batch_per_shard=256,
                                           window=512, stack=8)
    assert cell.config["index_input"] == run.Cell(
        ROOT, "k31-chr1-count").config["index_input"]
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "build_kmers_per_s", "query_kmers_per_s",
        "peak_bytes_per_kmer"}
    assert set(cell.workload["limits"]) == {
        "emitted_gap", "count_mismatch", "key_mismatch", "distinct_gap",
        "query_gap", "owner_gap"}
    assert not any(cell.workload["limits"].values())
    # its own readers, and the count cell's but for what the sharded
    # job does not run (mid-ingest segments, the query's shadow insert)
    count = run.Cell(ROOT, "k31-chr1-count")
    assert set(cell_metrics()) == OWN_METRICS | (
        {m["name"] for m in count.per_layer}
        - {"segment_finalize_ms", "query_insert_ms"})
    assert all(cell.reader(m) for m in cell_metrics())


def test_tiny_cell_is_correct(tiny_root):
    res = run_cell(tiny_root, "tiny")
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert len(res["checks"]) == 6
    assert set(res["metrics"]) == {"setup_s", "build_kmers_per_s",
                                   "query_kmers_per_s",
                                   "peak_bytes_per_kmer"}


def test_forced_spill_is_correct_and_counted(traced):
    res, _, _ = traced
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["metrics"]["route_spill_rows"]["value"] > 0
    # the CPU has no device trace
    assert set(res["metrics"]) == host_metrics()


def _count_altered(mp):
    orig = readout.entries_u64

    def altered(state, params):
        bucket, hi, lo, idx, cnt = orig(state, params)
        cnt = cnt.copy()
        cnt[0] += 1
        return bucket, hi, lo, idx, cnt
    mp.setattr(readout, "entries_u64", altered)


def _shard_dropped(mp):
    """The third shard read out empty."""
    orig = readout.entries_u64
    calls = [0]

    def dropped(state, params):
        out = orig(state, params)
        calls[0] += 1
        return tuple(x[:0] for x in out) if calls[0] == 3 else out
    mp.setattr(readout, "entries_u64", dropped)


@pytest.mark.parametrize("fault", [_count_altered, _shard_dropped])
def test_fault_in_the_read_out_makes_the_run_incorrect(tiny_root,
                                                       monkeypatch, fault):
    fault(monkeypatch)
    res = run_cell(tiny_root, "tiny")
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["count_mismatch"]["value"] > 0
    assert res["checks"]["key_mismatch"]["value"] > 0


def test_rows_left_on_their_source_shard_make_the_run_incorrect(
        tiny_root, monkeypatch):
    """A route that keeps every row on its source shard, none counted as
    spilled: the counts, keys and totals all hold; owner_gap does not."""
    real = sharded._route_local

    def to_source(rows, bucket, valid, n_shards, cap):
        src = torch.arange(rows.shape[0], device=rows.device)[:, None]
        return real(rows, src.expand_as(bucket), valid, n_shards, cap)
    monkeypatch.setattr(sharded, "_route_local", to_source)
    res = run_cell(tiny_root, "tiny-wide")
    assert res["correct"] is False and res["failed"] >= 1
    checks = {n: c["value"] for n, c in res["checks"].items()}
    assert checks.pop("owner_gap") > 0
    assert not any(checks.values()), checks


def test_a_key_split_past_256_is_summed_before_the_wrap(tmp_path):
    """300 copies of one read, 10 k-mers each, at SPILL_CAP: each k-mer's
    300 rows split over its owner and spill shards, and the query of the
    same reads reads each emission's count as (summed) mod 256, as the
    reference does."""
    g = torch.Generator().manual_seed(7)
    read = "".join("ACGT"[int(i)] for i in torch.randint(4, (40,),
                                                         generator=g))
    path = str(tmp_path / "repeats.fa")
    with open(path, "w") as f:
        f.write("".join(f">r{i}\n{read}\n" for i in range(300)))
    sb = ShardedBrisk(Parameters(31, 15, 14), n_devices=8,
                      batch_per_shard=32, window=64, stack=2,
                      skl_route_cap=SPILL_CAP, device="cpu")
    sb.insert_file(path)
    got = sb.query_file(path)
    held = [kv for kv, _ in sb.items()]
    assert sb.n_spilled > 0 and len(held) > len(set(held))
    words = compare.key_words(*keying.emission_keys(
        torch.from_numpy(fasta.read_codes(path)), 31, 15), 31)
    keys, counts, _ = kmers.count_words(words)
    assert int(counts.max()) == 300
    assert got == compare.query_expected(keys, counts, words)


def test_readers_read_the_traced_run(traced, tiny_root, monkeypatch):
    res, record, recs = traced
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    cell = run.Cell(tiny_root, "tiny-spill")
    got = {m: cell.reader(m)(record) for m in host_metrics()}
    assert all(v is not None for v in got.values()), got
    for m, v in res["metrics"].items():
        assert got[m] == pytest.approx(v["value"])
    assert got["shard_rows_skew"] >= 1 and got["query_enum_ms"] > 0
    assert got["join_expand_ms"] > 0 and got["join_merge_ms"] > 0
    assert got["pack_ms"] > 0 and got["arena_bytes_per_kmer"] > 0


def _before_the_cells_spans(recs: list) -> list:
    """The span list as the facade made it before this cell: no
    finalize or query_file call (the top of a path), no
    query.enumerate, shard.stack or deliver leaf."""
    out = []
    for r in recs:
        if r.name in NEW_SPANS or (r.kind == "call"
                                   and r.name in NEW_CALLS):
            continue
        path = r.parent.split("/") if r.parent else []
        if path and path[0] in NEW_CALLS:
            path = path[1:]
        out.append(r._replace(parent="/".join(
            p for p in path if p not in NEW_SPANS)))
    return out


def test_readers_read_nothing_without_spans_or_counters(traced, tiny_root,
                                                        monkeypatch):
    _, record, recs = traced
    cell = run.Cell(tiny_root, "tiny-spill")
    bare = {n: v for n, v in record.items()
            if n not in ("n_spilled", "shard_entries")}
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert {m: cell.reader(m)(bare) for m in OWN_METRICS} == {
        m: None for m in OWN_METRICS}
    older = _before_the_cells_spans(recs)
    monkeypatch.setattr(program_spans, "records", lambda: older)
    assert cell.reader("query_enum_ms")(record) is None
    assert cell.reader("pack_ms")(record) > 0
