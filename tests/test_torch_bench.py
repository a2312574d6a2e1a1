"""The port's measurement tools on the CPU: io.synth writes the same bytes
as tests/make_synth_fasta.write_synth; every stage of
brisk_tpu_torch.bench, at a tiny size on the CPU, reports the same
correctness fields as brisk_tpu.api.Brisk on the same file (k-mers
emitted, repaired windows, overflows, resident bytes per k-mer, segment
count under the same small segment_rows; the query total equals the
oracle's); a failing stage yields `<stage>_error` and exit code 3;
trace_insert, profile_device and profile_sort run and report their spans
and rows; and every entry point raises without a card unless it is
given `--device cpu`."""

import json
import types

import numpy as np
import pytest
import torch

from brisk_tpu.api import Brisk as JBrisk
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch import (bench, profile_device, profile_insert,
                             profile_sort, trace_insert)
from brisk_tpu_torch.io import synth
from brisk_tpu_torch.oracle import pyref
from tests.make_synth_fasta import write_synth as reference_write_synth

torch.set_num_threads(2)

CPU = torch.device("cpu")
GEO31 = dict(batch=32, window=64, stack=2)
GEO63 = dict(batch=16, window=256, stack=2)
GEO63_SHORT = dict(batch=64, window=256, stack=2)
E2E_BASES, K63_BASES, SCALE_BASES = 60_000, 30_000, 30_000
SEGMENT_ROWS = 1 << 11
# tiny sizes for main(--quick) on the CPU
TINY = dict(
    product=dict(rec_bases=20_000, **GEO31),
    e2e=dict(n_bases=20_000, **GEO31),
    expand=dict(rows=1024),
    k63=dict(n_bases=10_000, **GEO63),
    k63_short=dict(n_bases=10_000, **GEO63_SHORT),
    scale500=dict(n_bases=30_000, segment_rows=SEGMENT_ROWS, **GEO31),
    sharded=dict(steps=3, **GEO31),
)


@pytest.mark.parametrize("read_len", [0, 150, 10_000])
def test_synth_is_byte_identical(tmp_path, read_len):
    a, b = str(tmp_path / "ref.fa"), str(tmp_path / "port.fa")
    reference_write_synth(a, 25_000, read_len=read_len, seed=77)
    synth.write_synth(b, 25_000, read_len=read_len, seed=77)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_data"))


def _jax_run(path, kmb, geo, read_len=None, segment_rows=None):
    """brisk_tpu's Brisk through warmup -> insert_file -> finalize."""
    br = JBrisk(JParameters(*kmb), **geo)
    if segment_rows is not None:
        br.segment_rows = segment_rows
    kw = {} if read_len is None else dict(record_len_hint=read_len)
    import os
    br.warmup(os.path.getsize(path), path=path, **kw)
    br.insert_file(path)
    br.finalize()
    return br


def _query_total(path, k, m) -> int:
    """The oracle's query_file total of a file against itself: every
    emission of k-mer x adds count(x), so the total is sum(count^2)."""
    return sum(c * c for c in pyref.count_fasta(path, k, m).values()) \
        & 0xFFFFFFFF


def test_e2e_stage_matches_brisk_tpu(data_dir):
    got = bench.e2e_bench(CPU, data_dir, n_bases=E2E_BASES, **GEO31)
    path = bench.synth_path(data_dir, E2E_BASES)
    jb = _jax_run(path, (31, 11, 8), GEO31)
    assert got["e2e_nb_kmers"] == jb.n_emitted
    assert got["e2e_repaired_windows"] == jb.n_repaired_windows
    assert got["e2e_skl_overflows"] == jb.n_skl_overflows
    assert got["e2e_skl_overflows"] > 0  # this geometry rebuilds lanes
    ss = jb.skl_stats()
    assert got["resident_bytes_per_kmer"] == round(ss["bytes_per_kmer"], 2)
    assert got["avg_kmers_per_superkmer_row"] == round(
        ss["avg_kmers_per_skl"], 2)
    assert got["query_file_total_mod256"] == _query_total(path, 31, 11)
    assert got["e2e_peak_gib"] is None  # no device number on the CPU


@pytest.mark.parametrize("stage", ["k63", "k63_short"])
def test_k63_stages_match_brisk_tpu(data_dir, stage):
    if stage == "k63":
        got = bench.k63_e2e_bench(CPU, data_dir, n_bases=K63_BASES, **GEO63)
        read_len, geo, prefix = 10_000, GEO63, "k63_"
    else:
        got = bench.k63_short_read_bench(CPU, data_dir, n_bases=K63_BASES,
                                         **GEO63_SHORT)
        read_len, geo, prefix = 150, GEO63_SHORT, "k63_shortread_"
    path = bench.synth_path(data_dir, K63_BASES, read_len)
    jb = _jax_run(path, (63, 21, 14), geo, read_len=read_len)
    assert got[prefix + "nb_kmers"] == jb.n_emitted
    assert jb.n_emitted == sum(len(s) - 62 for s in
                               pyref.read_fasta_chunks(path) if len(s) >= 63)
    if stage == "k63":
        assert got["k63_repaired_windows"] == jb.n_repaired_windows == 0


def test_scale_stage_segments_match_brisk_tpu(data_dir):
    got = bench.scale_500mb_bench(CPU, data_dir, n_bases=SCALE_BASES,
                                  segment_rows=SEGMENT_ROWS, **GEO31)
    path = bench.synth_path(data_dir, SCALE_BASES)
    jb = _jax_run(path, (31, 11, 8), GEO31, segment_rows=SEGMENT_ROWS)
    assert got["scale500_segments"] == len(jb._skl_segments) >= 2
    assert got["scale500_nb_kmers"] == jb.n_emitted
    assert got["scale500_skl_overflows"] == jb.n_skl_overflows
    assert got["scale500_repaired_windows"] == jb.n_repaired_windows
    assert got["scale500_rows"] == int(jb.skl.n_rows)
    assert got["scale500_segment_rows"] == SEGMENT_ROWS
    assert got["scale500_peak_gib"] is None


def test_sharded_stage_counts_agree():
    got = bench.sharded_overhead(CPU, steps=3, **GEO31)
    assert got["sharded_nb_kmers_n1"] == got["sharded_nb_kmers_n8"] > 0
    assert got["sharded_n_spilled_n1"] == got["sharded_n_spilled_n8"] == 0
    assert got["sharded_steps_timed"] == 3
    assert got["sharded_overhead_ratio_n8_vs_n1"] == pytest.approx(
        got["sharded_step_ms_n8"] / got["sharded_step_ms_n1"])


def test_product_and_expand_stages_on_the_cpu():
    got = bench.product_device_bench(CPU, rec_bases=60_000, **GEO31)
    assert got["metric"] == "product_device_kmers_per_sec_single_chip_k31"
    assert got["product_stacks"] == 3 and got["value"] > 0
    assert got["product_kmers"] > 0 and got["product_rows_per_trial"] > 0
    exp = bench.expand_bench(CPU, rows=4096)
    assert exp["expand_kernel_ms"] is None and exp["expand_plain_ms"] is None
    assert exp["expand_bound_ms"] > 0 and exp["expand_bound_by"] == "bytes"


def _main_json(capsys, argv) -> tuple:
    rc = bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu, None"
    return rc, json.loads(lines[-1])


def test_main_quick_runs_every_stage(monkeypatch, capsys, data_dir):
    monkeypatch.setattr(bench, "QUICK", TINY)
    rc, rec = _main_json(capsys, ["--device", "cpu", "--quick",
                                  "--data-dir", data_dir])
    assert rc == 0
    assert not [key for key in rec if key.endswith("_error")]
    assert rec["device_name"] == "cpu" and rec["quick"] is True
    for key in ("value", "e2e_nb_kmers", "expand_bound_ms", "k63_nb_kmers",
                "k63_shortread_nb_kmers", "scale500_segments",
                "sharded_step_ms_n8"):
        assert key in rec, key
    assert rec["scale500_segments"] >= 2


def test_failing_stage_records_error_and_exits_3(monkeypatch, capsys,
                                                 data_dir):
    def broken(*args, **kw):
        raise ValueError("stage broke")

    monkeypatch.setattr(bench, "QUICK", TINY)
    monkeypatch.setattr(bench, "k63_e2e_bench", broken)
    rc, rec = _main_json(capsys, ["--device", "cpu", "--quick", "--stages",
                                  "expand,k63", "--data-dir", data_dir])
    assert rc == 3
    assert rec["k63_error"] == "ValueError: stage broke"
    assert "expand_bound_ms" in rec
    # the primary metric is not caught
    monkeypatch.setattr(bench, "product_device_bench", broken)
    with pytest.raises(ValueError, match="stage broke"):
        bench.main(["--device", "cpu", "--quick", "--stages", "product"])


def test_trace_spans_on_the_cpu(tmp_path):
    rows = trace_insert.trace(CPU, str(tmp_path), rec_bases=20_000,
                              query_bases=5_000, batch=16, window=64,
                              stack=2)
    assert [r["span"] for r in rows] == list(trace_insert.SPANS)
    for r in rows:
        assert r["cpu_ops"] > 0 and r["untraced_wall_ms"] > 0
        assert r["launches"] is None and r["device_idle_share"] is None
    assert rows[-1]["query_total"] > 0
    assert all(r["attempts"] == 1 for r in rows)
    for name in trace_insert.SPANS:
        assert (tmp_path / f"trace_{name}.json").stat().st_size > 0


def test_trace_query_file_at_a_deployment_on_the_cpu(tmp_path):
    """The query_file span at a (tiny) deployment: its total equals the
    port's own untraced query_file on the same input, the span holds CPU
    ops, and the trace is written."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    geo = dict(batch=16, window=64, stack=2)
    r = trace_insert.trace_query_file(CPU, str(tmp_path), 30_000,
                                      str(tmp_path), **geo)
    assert r["span"] == "query_file" and r["n_bases"] == 30_000
    assert r["cpu_ops"] > 0 and r["untraced_wall_ms"] > 0
    assert r["launches"] is None and r["hand_kernels"] is None
    idx = Brisk(Parameters(31, 11, 8), device="cpu", **geo)
    path = bench.synth_path(str(tmp_path), 30_000)
    idx.insert_file(path)
    assert r["query_total"] == idx.query_file(path) > 0
    assert (tmp_path / "trace_query_file.json").stat().st_size > 0


def test_span_summaries_on_device_events():
    """The card-side arithmetic on hand-made events of one span's
    session: launches count the session's kernels (a kernel whose
    timestamps fall outside the span still counts, and is reported in
    outside_span), busy time is the union of kernel and memcpy intervals,
    idle = 1 - busy / wall, top kernels by device time."""
    from torch.autograd import DeviceType

    def ev(name, start, end, dev=DeviceType.CUDA):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))

    events = [ev("flush", 0, 1000, DeviceType.CPU),
              ev("aten::where", 90, 110, DeviceType.CPU),
              ev("flush", 0, 1000),           # the span's GPU annotation
              ev("k_a", 100, 200), ev("k_a", 150, 250), ev("k_b", 400, 700),
              ev("Memcpy HtoD", 690, 720), ev("k_c", 1010, 1060)]
    cuda = torch.device("cuda", 0)
    f = trace_insert.span_summary(events, cuda, "flush")
    assert f["launches"] == 4 and f["memcpy_memset"] == 1
    assert f["outside_span"] == 1
    assert f["busy_ms"] == pytest.approx(0.52)  # 100-250, 400-720, 1010-60
    assert f["device_idle_share"] == pytest.approx(1 - 0.52 / 1.0)
    assert [t["name"] for t in f["top_kernels"]] == ["k_b", "k_a", "k_c"]
    assert f["top_kernels"][1] == dict(name="k_a", launches=2, ms=0.2)
    cpu = trace_insert.span_summary(events, torch.device("cpu"), "flush")
    assert cpu["cpu_ops"] == 1 and cpu["launches"] is None
    with pytest.raises(trace_insert.NoDeviceActivity,
                       match="no CUDA activity in span flush"):
        trace_insert.span_summary(events[:3] + events[6:7], cuda, "flush")
    with pytest.raises(RuntimeError, match="span finalize missing"):
        trace_insert.span_summary(events, cuda, "finalize")


def test_span_summary_counts_the_hosts_launch_calls():
    """host_launch_calls counts the span's CUDA API calls (cuda*, cu*)
    on the CPU timeline that launch a kernel or a graph or copy or set
    memory (host_calls by name), not other runtime calls, not calls
    outside the span; launches still counts the device's kernels, one per
    kernel of a graph replay."""
    from torch.autograd import DeviceType

    def ev(name, start, end, dev=DeviceType.CPU):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))

    events = [ev("flush", 0, 1000),
              ev("cudaMemcpyAsync", 10, 12), ev("cudaMemcpyAsync", 12, 14),
              ev("cudaGraphLaunch", 20, 40), ev("cudaLaunchKernel", 50, 52),
              ev("cuLaunchKernel", 60, 62), ev("cudaMemsetAsync", 70, 71),
              ev("cudaStreamIsCapturing", 80, 81),
              ev("cudaEventRecord", 82, 83), ev("aten::clone", 84, 90),
              ev("cudaLaunchKernel", 1010, 1012)]
    events += [ev(f"kernel_{i}", 100 + 10 * i, 105 + 10 * i,
                  DeviceType.CUDA) for i in range(30)]
    r = trace_insert.span_summary(events, torch.device("cuda", 0), "flush")
    assert r["host_launch_calls"] == 6
    assert r["host_calls"] == {"cudaMemcpyAsync": 2, "cudaGraphLaunch": 1,
                               "cudaLaunchKernel": 1, "cuLaunchKernel": 1,
                               "cudaMemsetAsync": 1}
    assert r["launches"] == 30
    cpu = trace_insert.span_summary(events, torch.device("cpu"), "flush")
    assert cpu["host_launch_calls"] is None and cpu["host_calls"] is None


def test_span_summary_names_the_hand_kernels():
    """hand_kernels sums the launches and device time of the port's own
    kernels by their device functions' names: the join scan's three
    passes count as join_scan; library kernels count as none."""
    from torch.autograd import DeviceType

    def ev(name, start, end, dev=DeviceType.CUDA):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))

    events = [ev("query_join", 0, 1000, DeviceType.CPU),
              ev("void cub::DeviceRadixSortOnesweepKernel", 10, 300),
              ev("void (anonymous namespace)::join_scan_reduce<3>(...)",
                 300, 350),
              ev("(anonymous namespace)::join_scan_carries(...)", 350, 360),
              ev("void (anonymous namespace)::join_scan_apply<3>(...)",
                 360, 420),
              ev("void (anonymous namespace)::expand_span_kernel<8>(...)",
                 420, 500)]
    r = trace_insert.span_summary(events, torch.device("cuda", 0),
                                  "query_join")
    assert r["hand_kernels"] == dict(
        join_scan=dict(launches=3, ms=pytest.approx(0.12)),
        expand_span=dict(launches=1, ms=pytest.approx(0.08)))
    cpu = trace_insert.span_summary(events, torch.device("cpu"),
                                    "query_join")
    assert cpu["hand_kernels"] is None


def test_trace_retries_a_session_without_device_activity(monkeypatch,
                                                         tmp_path):
    """A traced pass whose session lost its device events is run again,
    and the run raises once every attempt has lost them."""
    calls = []

    def flaky(run, activities, out_dir):
        calls.append(1)
        if len(calls) < 2:
            raise trace_insert.NoDeviceActivity("lost")
        return real(run, activities, out_dir)

    real = trace_insert._traced_pass
    monkeypatch.setattr(trace_insert, "_traced_pass", flaky)
    size = dict(rec_bases=20_000, query_bases=5_000, batch=16, window=64,
                stack=2)
    rows = trace_insert.trace(CPU, str(tmp_path), **size)
    assert [r["attempts"] for r in rows] == [2] * len(trace_insert.SPANS)

    def lost(run, activities, out_dir):
        raise trace_insert.NoDeviceActivity("lost")

    monkeypatch.setattr(trace_insert, "_traced_pass", lost)
    with pytest.raises(trace_insert.NoDeviceActivity):
        trace_insert.trace(CPU, str(tmp_path), attempts=2, **size)


def test_profiles_on_the_cpu():
    rows = profile_device.profile(CPU, batch=16, length=64, stack=2)
    assert [r["stage"] for r in rows] == [
        "position_pipeline", "pipeline+rescan", "enumerate_batch",
        "insert_flat_sklnative", "insert+finalize", "finalize_device"]
    assert all(r["ms"] > 0 and r["mkmer_per_s"] > 0 for r in rows)
    rows = profile_sort.profile(CPU, n=1 << 12,
                                row_batches=((16, 256), (4, 1024)))
    assert len(rows) == len(profile_sort.SORTS) + 4
    assert all(r["ms"] > 0 for r in rows)


def test_profile_insert_on_the_cpu(tmp_path):
    """profile_insert's flush rows (one per path; on the CPU both run the
    eager program, so no kernel differs) and its pace row: every turn
    emits the k-mers a Brisk of the same geometry emits."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    geo = dict(batch=16, window=64, stack=2)
    rows = profile_insert.flush_profile(CPU, rec_bases=20_000, flushes=2,
                                        **geo)
    assert [r["path"] for r in rows] == list(profile_insert.PATHS)
    for r in rows:
        assert r["steady_flush_ms"] > 0 and r["traced_wall_ms"] > 0
        assert r["host_launch_calls"] is None
        assert r["kernels_unlike_other_path"] == {}
    p = profile_insert.pace(CPU, str(tmp_path), 30_000, **geo)
    assert p["flushes"] > 0 and p["parse_s"] > 0 and p["pack_flat_s"] > 0
    assert [len(p["insert_parsed_s"][x]) for x in profile_insert.PATHS] == [
        2, 2]
    br = Brisk(Parameters(31, 11, 8), device="cpu", **geo)
    br.insert_file(bench.synth_path(str(tmp_path), 30_000))
    br._drain()
    assert p["n_emitted"] == br.n_emitted > 0


def test_insert_spans_and_breakdowns_on_the_cpu(tmp_path, monkeypatch):
    """trace_insert's payload and sharded spans (INSERT_SPANS; on the CPU
    the graph runner runs the eager program) at tiny geometries of equal
    lanes: each span holds CPU ops and emits the same k-mers of the first
    flush; each insert's breakdown, read from the program's spans,
    counts one flush call per flush and one pack call per batch
    (BriskData) or for the window table and per stack (ShardedBrisk), per
    stack staged and for the next() that finds the packer exhausted, and
    its insert emits what a BriskData of the same geometry emits, as do
    its graph / eager turns. --inserts needs --deploy-bases."""
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.params import Parameters
    monkeypatch.setattr(trace_insert, "PAYLOAD_GEOMETRY", dict(
        width=2, kinds=("sum", "max"), batch=32, window=64, stack=2))
    monkeypatch.setattr(trace_insert, "SHARDED_GEOMETRY", dict(
        n_devices=8, batch_per_shard=4, window=64, stack=2))
    path = bench.synth_path(str(tmp_path), 30_000)
    rows = trace_insert.trace_inserts(CPU, str(tmp_path), path)
    assert [r["span"] for r in rows] == list(trace_insert.INSERT_SPANS)
    assert len({r["n_km"] for r in rows}) == 1 and rows[0]["n_km"] > 0
    for r in rows:
        assert r["cpu_ops"] > 0 and r["untraced_wall_ms"] > 0
        assert r["launches"] is None
        assert (tmp_path / f"trace_{r['span']}.json").stat().st_size > 0
    bd = BriskData(Parameters(31, 11, 8), device="cpu",
                   **trace_insert.PAYLOAD_GEOMETRY)
    bd.insert_file(path)
    for which in ("payload", "sharded"):
        b = trace_insert.insert_breakdown(CPU, path, which)
        assert b["which"] == which and b["n_emitted"] == bd.n_emitted > 0
        assert b["parse_calls"] == 1
        # full stacks of 2 batches; ShardedBrisk lays a stack out at once
        per_flush, once = (3, 1) if which == "payload" else (2, 2)
        assert b["pack_calls"] == per_flush * b["flush_calls"] + once > 2
        assert b["read_back_calls"] >= b["flush_calls"]
        assert (b["compact_calls"] > 0) == (which == "payload")
        assert b["insert_s"] >= b["flush_s"] > 0
        t = trace_insert.insert_turns(CPU, path, which, ("eager", "graph"))
        assert t["n_emitted"] == bd.n_emitted
        assert [len(t["insert_s"][x]) for x in ("graph", "eager")] == [1, 1]
    assert "cpu" not in vars(torch.Tensor)  # Tensor.cpu restored
    with pytest.raises(SystemExit):
        trace_insert.main(["--device", "cpu", "--inserts"])


@pytest.mark.parametrize("entry", ["bench", "trace_insert", "profile_device",
                                   "profile_sort", "profile_insert"])
def test_entry_points_need_a_card_unless_asked(entry):
    """Without `--device cpu` every entry point runs on the first CUDA
    card, and raises without one."""
    main = dict(bench=bench.main, trace_insert=trace_insert.main,
                profile_device=profile_device.main,
                profile_sort=profile_sort.main,
                profile_insert=profile_insert.main)[entry]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--stages", "expand"] if entry == "bench" else [])
