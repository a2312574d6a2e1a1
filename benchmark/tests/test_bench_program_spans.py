"""The readers of the program's own spans (benchmark/program_spans.py) on
a hand-made record and span list against values worked out by hand; the
mapping's refusal when its offsets spread; a traced CPU run of each tiny
cell in which every new time metric reads a number; and on the card, a
span around one kernel and a synchronize that, mapped, holds the
kernel's CUPTI interval."""

import collections
import io
import json

import pytest

from benchmark import program_spans, run

from conftest import ROOT

Span = collections.namedtuple(
    "Span", "name parent thread start_ns end_ns kind")
BASE = 1_760_000_000_000_000_000  # the list's epoch ns at the trace's 0
TIMES = ["parse_ms", "pack_ms", "flush_host_ms", "readback_ms", "alloc_ms",
         "segment_finalize_ms", "query_insert_ms", "join_expand_ms",
         "join_merge_ms"]
SHARES = ["idle_unnamed_share.build", "idle_unnamed_share.query"]


def reader(name):
    return run.Cell(ROOT, "k31-chr1-count").reader(name)


# (name, parent, thread, start us, end us, kind); thread 2 is the
# insert's producer, which the profiler does not see
JOB = [("Brisk", "", 1, 0, 50, "call"),
       ("alloc", "Brisk", 1, 10, 40, "range"),
       ("insert_file", "", 1, 50, 1500, "call"),
       ("parse", "insert_file", 1, 60, 400, "range"),
       ("pack", "insert_file", 2, 400, 600, "leaf"),
       ("flush", "insert_file", 1, 600, 700, "range"),
       ("capture", "insert_file/flush", 1, 610, 650, "range"),
       ("pack", "insert_file", 2, 700, 800, "leaf"),
       ("readback", "insert_file", 1, 900, 950, "range"),
       ("finalize", "insert_file", 1, 1000, 1400, "call"),
       ("finalize", "insert_file/finalize", 1, 1010, 1300, "range"),
       ("alloc", "insert_file/finalize/finalize", 1, 1100, 1150, "range"),
       ("readback", "insert_file/finalize", 1, 1300, 1320, "range"),
       ("finalize", "", 1, 1500, 2000, "call"),
       ("finalize", "finalize", 1, 1510, 1900, "range"),
       ("readback", "finalize", 1, 1900, 1950, "range"),
       ("query_file", "", 1, 2000, 3000, "call"),
       ("Brisk", "query_file", 1, 2000, 2050, "call"),
       ("alloc", "query_file/Brisk", 1, 2010, 2040, "range"),
       ("insert_file", "query_file", 1, 2050, 2500, "call"),
       ("parse", "query_file/insert_file", 1, 2060, 2100, "range"),
       ("join.expand", "query_file", 1, 2500, 2700, "range"),
       ("join.expand", "query_file", 1, 2700, 2750, "range"),
       ("join.merge", "query_file", 1, 2750, 2950, "range")]


def span_list(shift_us=()):
    """The job's spans on the list's clock, after an older run's (10 s
    earlier, no longer in any trace); the ranges listed in shift_us
    stamped that many us late."""
    old = [Span(n, p, t, BASE + 1000 * s - 10**10, BASE + 1000 * e - 10**10,
                k) for n, p, t, s, e, k in JOB]
    now = [Span(n, p, t, BASE + 1000 * (s + dict(shift_us).get(i, 0)),
                BASE + 1000 * (e + dict(shift_us).get(i, 0)), k)
           for i, (n, p, t, s, e, k) in enumerate(JOB)]
    return old + now


def record():
    """Times in us: build 0-2000 (insert 50-1500), query 2000-3000."""
    return dict(
        spans={"job": (0, 3000), "build": (0, 2000), "insert": (50, 1500),
               "finalize": (1500, 2000), "query": (2000, 3000)},
        device=[("k", 100, 300), ("k", 620, 690), ("k", 1020, 1290),
                ("k", 2200, 2300), ("k", 2600, 2650), ("k", 2800, 2900)],
        cpu=[("aten::item", 900, 950)] + [
            (program_spans.PREFIX + n, s, e)
            for n, _, _, s, e, k in JOB if k == "range"])


@pytest.mark.parametrize("name,want", [
    ("parse_ms", 0.34), ("pack_ms", 0.3), ("flush_host_ms", 0.06),
    ("readback_ms", 0.05 + 0.02 + 0.05), ("alloc_ms", 0.03 + 0.05),
    ("segment_finalize_ms", 0.24), ("graph_captures", 1),
    ("query_insert_ms", 0.45), ("join_expand_ms", 0.25),
    ("join_merge_ms", 0.2),
    # build idle 1460 us, 1030 of it under leaves; query 750, 370
    ("idle_unnamed_share.build", 100 * 430 / 1460),
    ("idle_unnamed_share.query", 100 * 380 / 750)])
def test_reader_value(monkeypatch, name, want):
    monkeypatch.setattr(program_spans, "records", span_list)
    assert reader(name)(record()) == pytest.approx(want)


@pytest.mark.parametrize("name", TIMES + ["graph_captures"] + SHARES)
def test_silent_without_the_programs_spans(monkeypatch, name):
    """An older program keeps no span list; one that ran no profiled
    range pairs nothing."""
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert reader(name)(record()) is None
    monkeypatch.setattr(program_spans, "records", span_list)
    rec = record()
    rec["cpu"] = [e for e in rec["cpu"] if e[0] == "aten::item"]
    assert reader(name)(rec) is None


def test_mapping_refuses_spread_offsets(monkeypatch):
    ranges = [i for i, j in enumerate(JOB) if j[5] == "range"]
    # half the ranges stamped 0.8 ms late: quartiles 0.8 ms apart
    late = span_list([(i, 800) for i in ranges[::2]])
    monkeypatch.setattr(program_spans, "records", lambda: late)
    assert program_spans.job(record()) is None
    assert reader("parse_ms")(record()) is None
    # one range 5 ms late (a thread switch between the two stamps): the
    # median and quartiles hold
    one = span_list([(ranges[-1], 5000)])
    monkeypatch.setattr(program_spans, "records", lambda: one)
    assert reader("parse_ms")(record()) == pytest.approx(0.34)


def test_own_time_by_hand():
    spans = span_list()[len(JOB):]
    own = program_spans.own_ns(spans)
    got = {(s.parent, s.name, s.start_ns): o for s, o in zip(spans, own)}
    assert got[("", "insert_file", BASE + 50_000)] == 1000 * (
        1450 - 340 - 100 - 50 - 400)  # the producer's packs not counted
    assert got[("insert_file", "flush", BASE + 600_000)] == 60_000
    assert got[("insert_file/finalize", "finalize", BASE + 1_010_000)] \
        == 240_000


@pytest.mark.parametrize("cell", ["tiny31", "tiny63"])
def test_traced_cpu_run_reads_every_span_metric(tiny_root, cell):
    out = io.StringIO()
    assert run.main(["--workload", cell, "--seed", str(2**31 + 7),
                     "--seconds", "1", "--trace", "1"], device="cpu",
                    root=tiny_root, out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    m = res["metrics"]
    for name in TIMES:
        assert isinstance(m[name]["value"], float), name
    for name in ("parse_ms", "pack_ms", "flush_host_ms", "readback_ms",
                 "query_insert_ms", "join_expand_ms", "join_merge_ms"):
        assert m[name]["value"] > 0, name
    assert m["graph_captures"]["value"] == 0
    assert not set(SHARES) & set(m)  # no device activity on the CPU
    gaps = res["breakdown"]["idle_gaps"]
    assert any(program_spans.PREFIX in label for label, _ in gaps)


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_card(card, capsys):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from brisk_tpu_torch import spans
    x = torch.rand(1 << 24, device=card)
    torch.cuda.synchronize()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            with spans.span("probe"):
                torch.mul(x, 3.0)
                torch.cuda.synchronize()
    rec = dict(device=[], cpu=[])
    on_device = []
    from torch.autograd import DeviceType
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            on_device.append(e.name)
            if "mul" in e.name or "elementwise" in e.name:
                rec["device"].append((e.name, s, t))
        else:
            rec["cpu"].append((e.name, s, t))
    recs = [r for r in spans.records() if r.name == "probe"]
    spans.clear()
    off, pairs = program_spans.offset_ns(recs, rec["cpu"])
    assert len(pairs) == 4
    # the list's own stamps, mapped by the median offset
    mapped = sorted(((r.start_ns + off) / 1e3, (r.end_ns + off) / 1e3)
                    for r in recs)
    kernels = sorted(rec["device"], key=lambda e: e[1])
    assert len(kernels) == 4
    # function-scope ranges: nothing of them on the device's timeline
    assert not [n for n in on_device if n.startswith(spans.PREFIX)]
    skew = [(round(ks - s, 3), round(e - ke, 3))
            for (s, e), (_, ks, ke) in zip(mapped, kernels)]
    with capsys.disabled():
        print(f"\nspan start to kernel start, kernel end to span end (us): "
              f"{skew}")
    assert all(a >= 0 and b >= 0 for a, b in skew)
