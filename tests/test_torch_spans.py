"""brisk_tpu_torch.spans on the CPU: off, the count job records nothing
and opens no profiler range; under torch.profiler its leaves are "brisk.*"
ranges and the k=31 insert's producer thread's pack spans are in the
list under insert_file; own times never count a child twice; the count job at
k=31 (with mid-ingest segments) and k=63 yields the expected span paths,
one flush span per flush; the list is capped; a thread takes its
starter's state through context() / adopt(); trace_insert's
insert_breakdown reads the spans, keeps its row's keys and patches
nothing; the parse's byte ranges are `parse.range` spans on worker
threads, which the benchmark's parse_ranges reader counts; the sharded
job (ShardedBrisk's insert_file, finalize and query_file) yields its
calls, its leaves under them and its own leaves (deliver, shard.stack,
query.enumerate) where they run."""

import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from brisk_tpu_torch import bench, native, spans, trace_insert
from brisk_tpu_torch.api import Brisk
from brisk_tpu_torch.index import flush_graph
from brisk_tpu_torch.parallel.facade import ShardedBrisk
from brisk_tpu_torch.params import Parameters

torch.set_num_threads(2)

CPU = torch.device("cpu")
DATA = "data/test.fa"
GEO = {31: dict(params=(31, 11, 8), batch=32, window=64, stack=2),
       63: dict(params=(63, 21, 9), batch=8, window=512, stack=1)}


def count_job(k: int) -> int:
    """The counter's workflow on DATA: Brisk(...) -> insert_file ->
    finalize -> query_file; at k=31 with segments cut mid-ingest."""
    g = GEO[k]
    br = Brisk(Parameters(*g["params"]), batch=g["batch"],
               window=g["window"], stack=g["stack"], device="cpu")
    br.segment_rows = 1 << 9
    br.insert_file(DATA)
    br.finalize()
    return br.query_file(DATA)


def paths(recs) -> set:
    return {(f"{r.parent}/" if r.parent else "") + r.name for r in recs}


def run_job(k: int, profiled: bool) -> tuple:
    """One count job, under torch.profiler or spans.recording(): (k, its
    spans, the profiler's "brisk.*" range names, the flushes run, the
    query total)."""
    name = "insert_flat" if k <= 32 else "insert_stream"
    real = getattr(flush_graph, name)
    flushes = [0]

    def counted(*args, **kw):
        flushes[0] += 1
        return real(*args, **kw)

    spans.clear()
    setattr(flush_graph, name, counted)
    try:
        with (profile(activities=[ProfilerActivity.CPU]) if profiled
              else spans.recording()) as prof:
            total = count_job(k)
    finally:
        setattr(flush_graph, name, real)
    recs = spans.records()
    spans.clear()
    ranges = [e.name for e in prof.events()
              if e.name.startswith(spans.PREFIX)] if profiled else []
    return k, recs, ranges, flushes[0], total


@pytest.fixture(scope="module")
def profiled():
    """The count job at k=31 under torch.profiler (at k=63 the profiler
    of the CPU's many small ops takes minutes)."""
    return run_job(31, True)


@pytest.fixture(scope="module", params=[31, 63])
def recorded(request, profiled):
    """The count job at k=31 (the profiled one) and at k=63 under
    spans.recording()."""
    return profiled if request.param <= 32 else run_job(63, False)


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []

    def counting(real):
        def opens(*args, **kw):
            opened.append(args)
            return real(*args, **kw)
        return opens

    monkeypatch.setattr(spans, "_RANGE", counting(spans._RANGE))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    spans.clear()
    assert not torch.autograd._profiler_enabled()
    assert spans.span("a") is spans.span("b") is spans.call("c")
    assert count_job(31) > 0
    assert spans.records() == [] and opened == []


def test_profiled_leaves_are_ranges_and_producer_packs(profiled):
    _, recs, ranges, _, total = profiled
    assert total > 0
    main = threading.get_native_id()
    on_main = [r for r in recs if r.thread == main and r.kind != "call"]
    assert on_main and {r.kind for r in on_main} == {"range"}
    # every leaf on the profiled thread is a range in the trace
    assert sorted(ranges) == sorted(spans.PREFIX + r.name for r in on_main)
    # pack_flat runs in the insert's producer thread, which the profiler
    # does not see
    packs = [r for r in recs if r.name == "pack"
             and r.parent == "insert_file"]
    assert packs and main not in {r.thread for r in packs}
    assert {r.kind for r in packs} == {"leaf"}


def test_count_job_paths(recorded):
    k, recs, _, _, _ = recorded
    want = {"Brisk", "Brisk/alloc", "insert_file", "insert_file/parse",
            "insert_file/pack", "insert_file/flush", "insert_file/readback",
            "finalize", "finalize/finalize", "query_file",
            "query_file/Brisk/alloc", "query_file/insert_file",
            "query_file/insert_file/parse", "query_file/insert_file/pack",
            "query_file/insert_file/flush", "query_file/join.expand",
            "query_file/join.merge"}
    if k <= 32:  # segments finalized mid-ingest
        want |= {"insert_file/finalize", "insert_file/finalize/finalize"}
    assert want <= paths(recs)
    assert not any(r.name == "capture" for r in recs)  # no graph on the CPU
    calls = {"Brisk", "insert_file", "finalize", "query_file"}
    assert {r.name for r in recs if r.kind == "call"} == calls


def test_one_flush_span_per_flush(recorded):
    _, recs, _, flushes, _ = recorded
    assert flushes > 0
    assert sum(r.name == "flush" for r in recs) == flushes


def test_own_time_counts_no_child_twice(recorded):
    _, recs, _, _, _ = recorded
    own = spans.self_ns(recs)
    assert all(o >= 0 for o in own)
    for i, r in enumerate(recs):
        if r.kind == "call" and not r.parent:  # a top entry point
            inside = [o for j, o in enumerate(own) if recs[j].thread ==
                      r.thread and r.start_ns <= recs[j].start_ns
                      and recs[j].end_ns <= r.end_ns]
            assert sum(inside) == r.end_ns - r.start_ns


def test_own_time_by_hand():
    S = spans.Span
    recs = [S("top", "", 1, 0, 100, "call"),
            S("step", "top", 1, 10, 30, "range"),
            S("alloc", "top/step", 1, 15, 25, "range"),
            S("step", "top", 1, 40, 50, "range"),
            S("alloc", "top/step", 1, 41, 42, "range"),
            S("pack", "top", 2, 5, 95, "leaf")]  # another thread
    assert spans.self_ns(recs) == [70, 10, 10, 9, 1, 90]


def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    spans.clear()
    with spans.recording():
        for _ in range(5):
            with spans.span("x"):
                pass
    assert len(spans.records()) == 3 and spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_context_and_adopt():
    spans.clear()
    got = []

    def worker(ctx):
        spans.adopt(ctx)
        with spans.span("inner"):
            got.append(threading.get_native_id())

    with spans.recording():
        with spans.call("outer"):
            t = threading.Thread(target=worker, args=(spans.context(),))
            t.start()
            t.join()
    t = threading.Thread(target=worker, args=(spans.context(),))
    t.start()
    t.join()
    recs = spans.records()
    spans.clear()
    inner = [r for r in recs if r.name == "inner"]
    assert len(inner) == 1 and inner[0].parent == "outer"
    assert inner[0].kind == "leaf" and inner[0].thread == got[0]


def test_insert_breakdown_reads_spans_and_patches_nothing(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(trace_insert, "PAYLOAD_GEOMETRY", dict(
        width=2, kinds=("sum", "max"), batch=32, window=64, stack=2))
    path = bench.synth_path(str(tmp_path), 20_000)
    before = (native.parse_fasta_codes, flush_graph.insert_payload,
              vars(torch.Tensor).get("cpu"))
    seen = []
    real = flush_graph.insert_payload

    def flush(*args, **kw):
        seen.append((native.parse_fasta_codes, vars(torch.Tensor).get(
            "cpu")))
        return real(*args, **kw)

    monkeypatch.setattr(flush_graph, "insert_payload", flush)
    row = trace_insert.insert_breakdown(CPU, path, "payload")
    # the program ran unpatched inside the breakdown
    assert set(seen) == {(before[0], before[2])}
    assert list(row) == [
        "stage", "which", "path", "insert_untimed_s", "insert_s",
        "n_emitted", "parse_s", "parse_calls", "pack_s", "pack_calls",
        "flush_s", "flush_calls", "read_back_s", "read_back_calls",
        "compact_s", "compact_calls", "rest_s"]
    assert row["flush_calls"] == len(seen) // 3 > 0  # three inserts
    assert row["parse_calls"] == 1 and row["read_back_calls"] > 0
    assert 0 < row["flush_s"] <= row["insert_s"]
    assert spans.records() == []


def test_parse_ranges_on_their_own_threads(tmp_path, monkeypatch):
    """A parse above the minimum range records one `parse.range` span a
    range, each on a worker thread under the `parse` span's path; the
    parse span's own time stays its whole length."""
    monkeypatch.setattr(native.os, "sched_getaffinity",
                        lambda pid: set(range(4)))
    path = tmp_path / "big.fa"
    line = b"ACGTTGCAAC" * 8 + b"\n"
    n_lines = (3 * native.MIN_RANGE) // len(line) + 1000
    with open(path, "wb") as f:
        f.write(b">a\n" + line * (n_lines // 2) + b">b\n"
                + line * (n_lines - n_lines // 2))
    br = Brisk(Parameters(31, 11, 8), batch=32, window=64, stack=2,
               device="cpu")
    spans.clear()
    with spans.recording():
        with spans.call("insert_file"):
            chunks = list(br._records(str(path)))
    recs = spans.records()
    spans.clear()
    assert [len(c) for c in chunks] == [80 * (n_lines // 2),
                                        80 * (n_lines - n_lines // 2)]
    (parse,) = [r for r in recs if r.name == "parse"]
    ranges = [r for r in recs if r.name == "parse.range"]
    assert len(ranges) == native._n_ranges(path.stat().st_size) == 3
    assert {r.parent for r in ranges} == {"insert_file/parse"}
    assert parse.thread not in {r.thread for r in ranges}
    assert len({r.thread for r in ranges}) == len(ranges)
    assert all(parse.start_ns <= r.start_ns <= r.end_ns <= parse.end_ns
               for r in ranges)
    own = dict(zip(recs, spans.self_ns(recs)))
    assert own[parse] == parse.end_ns - parse.start_ns


def test_parse_ranges_reader_on_a_recorded_job(profiled, monkeypatch):
    """benchmark/metrics/parse_ranges.py on the profiled count job: the
    build's insert_file parsed data/test.fa in one range (the query's
    shadow insert's range is not counted); without the span, nothing."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import program_spans, run
    _, recs, _, _, _ = profiled
    ranges = [r for r in recs if r.name == "parse.range"]
    assert sorted(r.parent for r in ranges) == [
        "insert_file/parse", "query_file/insert_file/parse"]
    # the trace's CPU ranges are the list's own, on the same clock
    record = dict(
        spans={"job": (min(r.start_ns for r in recs) / 1e3,
                       max(r.end_ns for r in recs) / 1e3)},
        cpu=[(spans.PREFIX + r.name, r.start_ns / 1e3, r.end_ns / 1e3)
             for r in recs if r.kind == "range"])
    read = run.Cell(root, "k31-chr1-count").reader("parse_ranges")
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    assert read(record) == 1
    monkeypatch.setattr(program_spans, "records", lambda: [
        r for r in recs if r.name != "parse.range"])
    assert read(record) is None


def test_sharded_job_paths(tmp_path):
    """ShardedBrisk -> insert_file / finalize / query_file on an input
    whose windows need repairs (so their rows are delivered): one
    `finalize` leaf a shard and one `shard.stack` under the finalize
    call; query_file's own finalize (nothing left to do) opens no call."""
    from tests.test_torch_api import _repair_fixture
    path = _repair_fixture(tmp_path / "repair.fa")
    sb = ShardedBrisk(Parameters(31, 11, 8), n_devices=8, batch_per_shard=8,
                      window=64, stack=2, device="cpu")
    spans.clear()
    with spans.recording():
        sb.insert_file(path)
        sb.finalize()
        total = sb.query_file(path)
    recs = spans.records()
    spans.clear()
    assert total > 0 and sb.n_repaired_windows > 0
    want = {"insert_file", "insert_file/parse", "insert_file/pack",
            "insert_file/flush", "insert_file/readback",
            "insert_file/repair", "insert_file/deliver", "finalize",
            "finalize/finalize", "finalize/shard.stack", "query_file",
            "query_file/query.enumerate", "query_file/join.expand",
            "query_file/join.merge"}
    assert want <= paths(recs)
    assert {r.name for r in recs if r.kind == "call"} == {
        "insert_file", "finalize", "query_file"}
    assert sum(r.kind == "call" for r in recs) == 3
    under = [r.name for r in recs if r.parent == "finalize"]
    assert under.count("finalize") == 8 and under.count("shard.stack") == 1
    assert sum(r.name == "join.expand" for r in recs) == 8
    assert sum(r.name == "flush" for r in recs) == sum(
        r.name == "readback" for r in recs)
