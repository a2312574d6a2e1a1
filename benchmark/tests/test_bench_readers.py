"""Each per-layer reader on a small recorded trace, against the value
worked out by hand, and silent where it finds nothing to read."""

import json
import os

import pytest

from benchmark import roofline, run, tracing

from conftest import ROOT


def reader(name):
    return run.Cell(ROOT, "k31-chr1-count").reader(name)


def record():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "counter-k31.json")) as f:
        cfg = json.load(f)
    # times in us: build 0-1000 (insert 0-800, finalize 800-1000),
    # query 1000-1500
    dev = [("void positions_kernel(PosArgs, long, int)", 10, 30),
           ("void rescan_kernel(RescanArgs, long, int)", 30, 60),
           ("state_scan_kernel(ScanArgs, int, int)", 60, 80),
           ("emit_kernel(EmitArgs, long, int)", 80, 90),
           ("void skl_rows_kernel<2>(RowArgs, Geo)", 90, 100),
           ("Memcpy HtoD (Pageable -> Device)", 95, 120),
           ("expand_span_kernel", 850, 950),
           ("cub::DeviceRadixSortOnesweepKernel<...>", 1100, 1200),
           ("join_scan_onepass<3>", 1200, 1250),
           ("at::native::elementwise_kernel", 1240, 1300)]
    return dict(spans={"job": (0, 1500), "build": (0, 1000),
                       "insert": (0, 800), "finalize": (800, 1000),
                       "query": (1000, 1500)},
                device=dev, cpu=[], config=cfg,
                job=dict(n_emitted=1000, n_superkmers=100),
                arena_bytes_per_kmer=3.96)


@pytest.mark.parametrize("name,want", [
    ("insert_ms", 0.8), ("finalize_ms", 0.2),
    ("insert_busy_ms", 0.11), ("finalize_busy_ms", 0.1),
    ("query_busy_ms", 0.2), ("sort_share", 50.0),
    ("idle_share.build", 100 * (1 - 0.21 / 1.0)),
    ("idle_share.query", 100 * (1 - 0.2 / 0.5)),
    ("arena_bytes_per_kmer", 3.96)])
def test_reader_value(name, want):
    assert reader(name)(record()) == pytest.approx(want)


def test_enum_roofline_by_hand():
    rec = record()
    p, geo = rec["config"]["params"], rec["config"]["enum_geometry"]
    least = (sum(roofline.batch_least_s(p["k"], p["m"], geo).values())
             + roofline.rows_least_s(1000, 100))
    measured_ms = (20 + 30 + 20 + 10 + 10) / 1e3
    got = reader("enum_roofline")(rec)
    assert got == pytest.approx(100 * least * 1e3 / measured_ms)


@pytest.mark.parametrize("name", ["insert_busy_ms", "finalize_busy_ms",
                                  "query_busy_ms", "sort_share",
                                  "enum_roofline", "idle_share.build",
                                  "idle_share.query"])
def test_reader_silent_without_device_activity(name):
    rec = record()
    rec["device"] = []
    assert reader(name)(rec) is None


def test_union_and_breakdown():
    assert tracing.union_ms([(0, 10), (5, 20), (30, 40)]) == 0.03
    rec = record()
    ev = tracing.clipped(rec["device"], 0, 1500)
    out = tracing.breakdown(rec, ev, 0, 1500)
    assert out["device_ops"][0][0].startswith("expand_span")
    label, longest = out["idle_gaps"][0]
    assert longest == pytest.approx(730e-6)  # 120 -> 850
    assert label.startswith("insert")
    assert len(out["idle_gaps"]) <= 10 and len(out["device_ops"]) <= 10
