"""Tests that need a CUDA card (marker `cuda`): the CUDA span expansion
kernel in both layouts against its plain PyTorch versions (random,
insert-shaped and mixed rows, ragged and misaligned spans), a small
index on the card
against the pure-Python oracle, and the k = 63 streaming insert and
consolidate_all on the card against the port on the CPU, array for
array, as are the payload store (index.payload), BriskData and the
sharded facade (8 shards on one card); `sklstore.probe` through the
kernel; the measurement tools (bench stages on the card against the
CPU, the profiler trace, the profiles, bench's default device); the
enumerator's kernels (kernels.state_scan, kernels.rescan) against their
plain versions, carry in and out, and their wrappers' checks; the run
scan of the query join and of compact (kernels.join_scan,
kernels.run_totals) against theirs, called repeatedly at shapes that
stress their look-back and replayed from a CUDA graph; the insert
programs as CUDA graph replays (index.flush_graph) against the eager
programs, bit for bit, and so the payload insert and the sharded step
(BriskData's and ShardedBrisk's flushes). They skip on a machine
without a card.
This file imports no jax; on the card's machine (which has no jax) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from brisk_tpu_torch import bench_expand, kernels
from brisk_tpu_torch.api import Brisk
from brisk_tpu_torch.index import sklstore
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _span(R, k, m, b, seed):
    cs, s_max, _, nw = sklstore.skl_dims(k, m, b)
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, 1 << (2 * b), R, dtype=np.uint32)
    bucket[rng.random(R) < 0.15] = 0xFFFFFFFF
    meta = rng.integers(0, 1 << 32, R, dtype=np.uint32)  # any meta
    nucs = rng.integers(0, 1 << 32, (nw, R), dtype=np.uint32)
    cols = [torch.from_numpy(a.view(np.int32).copy())
            for a in (bucket, meta, nucs)]
    return cols, s_max


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14), (63, 61, 1)])
@pytest.mark.parametrize("R", [1000, 1024, 12288])
def test_kernel_matches_plain_version(device, k, m, b, R):
    (sb, sm, sn), s_max = _span(R, k, m, b, seed=R + k)
    want = sklstore._expand_span_jmajor_torch(sb, sm, sn, k, m, b, s_max)
    before = kernels.LAUNCHES["expand_span_jmajor"]
    got = kernels.expand_span_jmajor(sb.to(device), sm.to(device),
                                     sn.to(device), k, m, b, s_max)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expand_span_jmajor"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14), (63, 61, 1)])
@pytest.mark.parametrize("R", [1000, 1024, 12288])
def test_rowmajor_kernel_matches_plain_version(device, k, m, b, R):
    """The row-major layout against sklstore._expand_span on the CPU
    (the plain row-major version), on rows with any meta."""
    (sb, sm, sn), s_max = _span(R, k, m, b, seed=R + k)
    want, _ = sklstore._expand_span(sb, sm, sn, k, m, b, s_max)
    before = dict(kernels.LAUNCHES)
    got = kernels.expand_span(sb.to(device), sm.to(device), sn.to(device),
                              k, m, b, s_max, layout="rowmajor")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expand_span_rowmajor"] == (
        before["expand_span_rowmajor"] + 1)
    assert kernels.LAUNCHES["expand_span_jmajor"] == (
        before["expand_span_jmajor"])
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("layout", ["jmajor", "rowmajor"])
@pytest.mark.parametrize("garbage", [0.0, 0.05])
@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14), (63, 61, 1)])
def test_kernel_insert_shaped_and_mixed_rows(device, layout, garbage,
                                             k, m, b):
    """Insert-shaped rows (every live row regular: the kernel's per-row
    super-k-mer path) and the same with 5% garbage meta, so one warp
    mixes regular rows with rows on the per-slot path."""
    sb, sm, sn, s_max = bench_expand.span_rows(8192, k, m, b, seed=k + m,
                                               device="cpu", garbage=garbage)
    want = bench_expand.plain(layout)(sb, sm, sn, k, m, b, s_max)
    got = kernels.expand_span(sb.to(device), sm.to(device), sn.to(device),
                              k, m, b, s_max, layout=layout)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("layout", ["jmajor", "rowmajor"])
@pytest.mark.parametrize("R,offset", [(1001, 0), (1002, 0), (1027, 0),
                                      (1024, 1), (1001, 3)])
def test_kernel_ragged_and_misaligned_spans(device, layout, R, offset):
    """R not a multiple of 4, and inputs that start off a 16-byte
    boundary: the kernel's word-by-word store path."""
    k, m, b = 31, 11, 8
    sb, sm, sn, s_max = bench_expand.span_rows(R + offset, k, m, b, seed=R,
                                               device="cpu", garbage=0.02)
    sb, sm, sn = sb[offset:], sm[offset:], sn[:, offset:].contiguous()
    want = bench_expand.plain(layout)(sb, sm, sn, k, m, b, s_max)
    cols = []
    for t in (sb, sm, sn):
        buf = torch.empty(t.numel() + offset, dtype=torch.int32,
                          device=device)
        cols.append(buf[offset:].view(t.shape).copy_(t))
    got = kernels.expand_span(*cols, k, m, b, s_max, layout=layout)
    assert torch.equal(got.cpu(), want)


def test_kernel_wrapper_checks(device):
    (sb, sm, sn), s_max = _span(1024, 31, 11, 8, seed=1)
    sb, sm, sn = sb.to(device), sm.to(device), sn.to(device)
    with pytest.raises(TypeError):
        kernels.expand_span_jmajor(sb.long(), sm, sn, 31, 11, 8, s_max)
    with pytest.raises(ValueError):
        kernels.expand_span_jmajor(sb, sm, sn[:, ::2], 31, 11, 8, s_max)
    with pytest.raises(ValueError, match="layout"):
        kernels.expand_span(sb, sm, sn, 31, 11, 8, s_max, layout="J")
    with pytest.raises(ValueError):
        kernels.expand_span(sb, sm.cpu(), sn, 31, 11, 8, s_max,
                            layout="rowmajor")
    with pytest.raises(ValueError):
        kernels.expand_span(sb, sm, sn, 31, 11, 8, 9, layout="rowmajor")


@pytest.mark.parametrize("path", ["data/test.fa", "data/debug_test.fa"])
def test_index_on_card_matches_oracle(device, path):
    idx = Brisk(Parameters(31, 11, 8), batch=16, window=64, device=device)
    before = kernels.LAUNCHES["expand_span_jmajor"]
    idx.insert_file(path)
    assert idx.counts_dict() == pyref.count_fasta(path, 31, 11)
    assert kernels.LAUNCHES["expand_span_jmajor"] > before
    assert idx.skl.bucket.device.type == "cuda"


def _rows(skl, s_max: int = 8) -> dict:
    """Host uint32 copy of the used rows and padded slots of an arena
    (s_max is 8 at both configurations tested here)."""
    cols = sklstore.to_numpy(skl)
    n, nd = cols["n_rows"], cols["n_fin_rows"]
    out = {f: cols[f][..., :n] for f in ("bucket", "meta", "nucs", "offs")}
    out["data"] = cols["data"][:nd * s_max]
    out["n"] = (n, nd, cols["n_fin_kmers"])
    return out


def _assert_rows_equal(a: dict, c: dict) -> None:
    assert a["n"] == c["n"]
    for f in ("bucket", "meta", "nucs", "offs", "data"):
        np.testing.assert_array_equal(a[f], c[f], err_msg=f)


def test_k63_stream_on_card_matches_cpu(device, tmp_path):
    """The k = 63 streaming insert (long records and the short-read
    route) gives the CPU port's arena on the card, after insert and
    after finalize, and finalize launches the kernel at W = 6."""
    rng = np.random.default_rng(4)
    reads = ["".join("ACGT"[c] for c in rng.integers(0, 4, 150))
             for _ in range(300)]
    short = tmp_path / "reads.fa"
    short.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    for path in ("data/test.fa", str(short)):
        built = []
        for dev in ("cpu", device):
            b = Brisk(Parameters(63, 21, 14), batch=16, window=128,
                      device=dev)
            b.insert_file(path)
            b._drain()
            built.append((b, _rows(b.skl)))
        (cpu, cpu_ins), (card, card_ins) = built
        _assert_rows_equal(cpu_ins, card_ins)
        before = kernels.LAUNCHES["expand_span_jmajor"]
        card.finalize()
        assert kernels.LAUNCHES["expand_span_jmajor"] > before
        cpu.finalize()
        _assert_rows_equal(_rows(cpu.skl), _rows(card.skl))
        assert card.counts_dict() == pyref.count_fasta(path, 63, 21)
        assert card.n_emitted == cpu.n_emitted
        assert card.skl.bucket.device.type == "cuda"


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14)])
def test_consolidate_all_on_card_matches_cpu(device, k, m, b):
    """Three finalized segments with cross-segment duplicates: the carry
    path on the card (the row-major kernel, no transpose; 2^18 chunks,
    dead-row drop) gives the CPU port's arena."""
    src = Brisk(Parameters(k, m, b), batch=16, window=128, device="cpu")
    for path in ("data/test.fa", "data/debug_test.fa", "data/test.fa"):
        src.insert_file(path)
        src.finalize()
    cols = sklstore.to_numpy(src.skl)
    cpu = sklstore.consolidate_all(sklstore.from_numpy(cols, "cpu"), k, m, b)
    before = dict(kernels.LAUNCHES)
    card = sklstore.consolidate_all(sklstore.from_numpy(cols, device),
                                    k, m, b)
    assert kernels.LAUNCHES["expand_span_rowmajor"] == (
        before["expand_span_rowmajor"] + 1)
    assert kernels.LAUNCHES["expand_span_jmajor"] == (
        before["expand_span_jmajor"])
    assert int(card.n_rows) < cols["n_rows"]
    _assert_rows_equal(_rows(cpu), _rows(card))


def _payload_columns(rng, W, D, n, n_distinct):
    """Random payload columns: duplicates, ~10% INVALID tombstones, lanes
    on both sides of 2^31 and near 2^32."""
    pool = rng.integers(0, 1 << 32, (W, n_distinct), dtype=np.uint64)
    pool[0] >>= 1
    keys = pool[:, rng.integers(0, n_distinct, n)].astype(np.uint32)
    keys[:, rng.random(n) < 0.1] = 0xFFFFFFFF
    data = rng.integers((1 << 32) - (1 << 20), 1 << 32, (D, n),
                        dtype=np.uint64).astype(np.uint32)
    data[:, ::3] = rng.integers(0, 1 << 31, (D, data[:, ::3].shape[1]))
    return keys, data


@pytest.mark.parametrize("W,kinds", [(3, ("sum", "max")),
                                     (6, ("sum", "max", "min"))])
def test_payload_compact_lookup_on_card_matches_cpu(device, W, kinds):
    """payload.compact and lookup on the card give the CPU's arrays on
    random states (sums past 2^32, max/min across 2^31)."""
    from brisk_tpu_torch.index import payload
    rng = np.random.default_rng(W)
    D = len(kinds)
    keys, data = _payload_columns(rng, W, D, 200_000, 50_000)
    states = []
    for dev in ("cpu", device):
        st = payload.from_numpy(keys, data, 0, keys.shape[1], dev)
        st = payload.ensure_room(st, 1000)
        states.append(payload.compact(st, kinds))
    cpu, card = (payload.to_numpy(s) for s in states)
    for f in ("keys", "data", "n_sorted", "n_used"):
        np.testing.assert_array_equal(card[f], cpu[f], err_msg=f)
    q = np.concatenate([keys[:, ::7], rng.integers(
        0, 1 << 31, (W, 5000)).astype(np.uint32)], axis=1)
    (cf, cv), (gf, gv) = (payload.lookup(s, torch.from_numpy(
        q.view(np.int32).copy()).to(s.keys.device)) for s in states)
    assert torch.equal(gf.cpu(), cf) and torch.equal(gv.cpu(), cv)
    assert bool(cf.any()) and not bool(cf.all())


@pytest.mark.parametrize("k,m,b,width", [(31, 11, 8, 2), (31, 11, 8, 3),
                                         (63, 21, 14, 2)])
def test_brisk_data_on_card_matches_cpu(device, tmp_path, k, m, b, width):
    """BriskData on the card equals the CPU port on data/debug_test.fa
    after insert_file, update, reallocate and save -> load."""
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.index import payload
    kinds = ("sum", "max", "min")[:width]
    built = [BriskData(Parameters(k, m, b), width=width, kinds=kinds,
                       batch=16, window=128, stack=2, device=dev)
             for dev in ("cpu", device)]

    def same():
        a, c = (payload.to_numpy(bd.state) for bd in built)
        for f in ("keys", "data", "n_sorted", "n_used"):
            np.testing.assert_array_equal(c[f], a[f], err_msg=f)
        assert built[0].n_emitted == built[1].n_emitted
        assert built[0].n_repaired_windows == built[1].n_repaired_windows

    for bd in built:
        bd.insert_file("data/debug_test.fa")
    same()
    entries = [list(bd.items()) for bd in built]  # compacts both
    assert entries[1] == entries[0]
    same()
    kmers = [pyref.num2str(v, k) for v, _ in entries[0][::400]]
    kmers.append("ACGT" * (k // 4) + "ACG"[:k % 4])
    vals = np.array([[3] * len(kmers)] + [list(range(len(kmers)))]
                    * (width - 1), np.uint32)
    for bd in built:
        bd.update(kmers, vals)
    same()
    assert [built[1].get(s) for s in kmers] == [built[0].get(s)
                                                for s in kmers]
    for bd in built:
        bd.reallocate()
    same()
    for i, dev in enumerate(("cpu", device)):
        path = str(tmp_path / f"pl{i}.npz")
        built[i].save(path)
        built[i] = BriskData.load(path, device=dev)
    assert built[1].state.keys.device.type == torch.device(device).type
    same()


def _arena_np(br) -> dict:
    """ShardedBrisk's shard-axis arena as numpy (uint32 columns, int64
    row counters)."""
    from brisk_tpu_torch import _u32
    return {name: (_u32.to_np(x) if x.dtype == torch.int32
                   else x.cpu().numpy())
            for name, x in zip(sklstore.SklState._fields, br.skl)}


def _write_repair_input(path):
    """data/test.fa, then the record of the repair fixture of
    tests/test_torch_api.py (windows that need exact repairs)."""
    import random
    rng = random.Random(5)

    def rs(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    rec = (rs(300) + "ACGTTGCA" * 200 + rs(300) + "AAAAAAAAAAAAC" * 80
           + rs(300))
    with open(path, "w") as fh:
        fh.write(open("data/test.fa").read() + ">repair\n" + rec
                 + "\n")


@pytest.mark.parametrize("k,m,b,route_cap", [(31, 11, 8, None),
                                             (31, 11, 8, 2),
                                             (63, 21, 14, None)])
def test_sharded_on_card_matches_cpu(device, tmp_path, k, m, b, route_cap):
    """ShardedBrisk with 8 shards on the card equals the same facade on
    the CPU, array for array, after insert_file (repairs; a forced spill
    at route_cap 2), finalize, reallocate and save -> load; the reads
    agree with the oracle, and the kernel ran on the card's path."""
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    path = str(tmp_path / "in.fa")
    _write_repair_input(path)
    geo = dict(n_devices=8, batch_per_shard=4, window=128, stack=2,
               skl_route_cap=route_cap)
    built = [ShardedBrisk(Parameters(k, m, b), device=dev, **geo)
             for dev in ("cpu", device)]

    def same(step):
        a, c = (_arena_np(br) for br in built)
        for f in a:
            np.testing.assert_array_equal(c[f], a[f], err_msg=f"{step} {f}")
        for attr in ("n_emitted", "n_superkmers", "n_spilled",
                     "n_repaired_windows", "n_skl_overflows"):
            assert getattr(built[0], attr) == getattr(built[1], attr), attr

    for br in built:
        br.insert_file(path)
    same("insert")
    assert built[1].n_repaired_windows > 0
    if route_cap:
        assert built[1].n_spilled > 0
    before = dict(kernels.LAUNCHES)
    for br in built:
        br.finalize()
    same("finalize")
    assert kernels.LAUNCHES["expand_span_jmajor"] > \
        before["expand_span_jmajor"]
    counts = built[1].counts_dict()
    assert counts == built[0].counts_dict() == pyref.count_fasta(path, k, m)
    assert built[1].query_file(path) == built[0].query_file(path)
    for br in built:
        br.reallocate()
    same("reallocate")
    for i, dev in enumerate(("cpu", device)):
        ck = str(tmp_path / f"sh{i}.npz")
        built[i].save(ck)
        built[i] = ShardedBrisk.load(ck, device=dev, **geo)
    assert built[1].skl.bucket.device.type == torch.device(device).type
    same("save-load")
    assert built[1].counts_dict() == counts


def test_probe_through_kernel_matches_host_probe(device):
    """sklstore.probe on the card (the row-major kernel over one bucket's
    rows, every segment) equals probe_np on a host copy, hits and misses,
    keys split across two segments."""
    from brisk_tpu_torch.index import keying
    k, m, b = 31, 11, 8
    br = Brisk(Parameters(k, m, b), batch=16, window=64, device=device)
    for _ in range(2):
        br.insert_file("data/test.fa")
        br.finalize()
    segs = br._skl_segments
    assert len(segs) == 2
    kmers = [pyref.num2str(v, k) for v in sorted(br.counts_dict())[::37]]
    kmers += ["ACGT" * 7 + "ACG", "T" * 31]
    buckets, cols = keying.key_batch(keying.strs_to_codes(kmers), m, b)
    cache = sklstore.host_cache(br.skl)
    before = kernels.LAUNCHES["expand_span_rowmajor"]
    for i, bk in enumerate(buckets):
        c = cols[:, i:i + 1]
        got = sklstore.probe(br.skl, c, int(bk), k, m, b, segments=segs,
                             bucket_col=cache["bucket"])
        want = sklstore.probe_np(cache, c, int(bk), k, m, b, segments=segs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert kernels.LAUNCHES["expand_span_rowmajor"] > before


# -- the measurement tools on the card (brisk_tpu_torch.bench,
#    trace_insert, profile_device, profile_sort) --------------------------

BENCH_GEO = dict(batch=32, window=64, stack=2)


def test_bench_stages_on_card_match_cpu(device, tmp_path):
    """Each bench stage at a tiny size reports the same correctness fields
    on the card as on the CPU; the expansion stage times the kernel
    against its bound."""
    from brisk_tpu_torch import bench
    data = str(tmp_path)
    runs = {}
    for dev in (torch.device("cpu"), torch.device(device)):
        runs[dev.type] = dict(
            bench.e2e_bench(dev, data, n_bases=60_000, **BENCH_GEO),
            **bench.k63_e2e_bench(dev, data, n_bases=30_000, batch=16,
                                  window=256, stack=2),
            **bench.scale_500mb_bench(dev, data, n_bases=30_000,
                                      segment_rows=1 << 11, **BENCH_GEO),
            **bench.sharded_overhead(dev, steps=3, **BENCH_GEO))
    cpu, card = runs["cpu"], runs["cuda"]
    for key in ("e2e_nb_kmers", "e2e_repaired_windows", "e2e_skl_overflows",
                "resident_bytes_per_kmer", "query_file_total_mod256",
                "k63_nb_kmers", "scale500_nb_kmers", "scale500_segments",
                "scale500_rows", "sharded_nb_kmers_n1", "sharded_nb_kmers_n8",
                "sharded_n_spilled_n8"):
        assert card[key] == cpu[key], key
    assert card["scale500_segments"] >= 2 and card["e2e_peak_gib"] > 0
    exp = bench.expand_bench(torch.device(device), rows=1 << 16)
    assert exp["expand_kernel_ms"] > 0 and exp["expand_plain_ms"] > 0
    assert 0 < exp["expand_share_of_bound"] < 1.5


def test_trace_on_card(device, tmp_path):
    """trace_insert on the card: every span launched kernels, was busy for
    part of its wall time, and names its top kernels."""
    from brisk_tpu_torch import trace_insert
    rows = trace_insert.trace(torch.device(device), str(tmp_path),
                              rec_bases=200_000, query_bases=50_000,
                              batch=64, window=128, stack=2)
    assert [r["span"] for r in rows] == list(trace_insert.SPANS)
    for r in rows:
        assert r["launches"] > 0 and 0 < r["device_idle_share"] < 1, r
        assert 0 < r["busy_ms"] <= r["traced_wall_ms"]
        assert r["top_kernels"] and r["cpu_ops"] is None
        assert r["outside_span"] >= 0 and r["attempts"] >= 1


def test_profiles_on_card(device):
    from brisk_tpu_torch import profile_device, profile_sort
    dev = torch.device(device)
    rows = profile_device.profile(dev, batch=256, length=256, stack=2)
    assert len(rows) == 11 and all(r["ms"] > 0 for r in rows)
    assert all(r["peak_gib"] > 0 and r["cuda_mallocs"] >= 0
               for r in rows[:6])
    assert [r["stage"] for r in rows[-5:]] == [
        "skl_rows", "emit", "state_scan", "rescan", "positions"]
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0
               and r["plain_ms"] > 0 for r in rows[-5:])
    rows = profile_sort.profile(dev, n=1 << 16,
                                row_batches=((64, 1024), (8, 8192)))
    assert len(rows) == len(profile_sort.SORTS) + 4
    assert all(r["ms"] > 0 for r in rows)


def test_bench_main_defaults_to_the_card(device, capsys, tmp_path):
    from brisk_tpu_torch import bench
    assert bench.main(["--quick", "--stages", "expand", "--data-dir",
                       str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["device"].startswith("cuda") and rec["power_limit_w"]
    assert rec["expand_kernel_ms"] > 0


# -- the enumerator's kernels (kernels.state_scan, kernels.rescan) against
#    their plain versions on the card --------------------------------------

def _enum_codes(B, L_buf, seed, device):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L_buf))
    codes[0, 5:L_buf - 5] = 0  # poly-A: ties at every offset
    codes[1 % B] = np.resize([0, 1, 3, 2, 2, 3, 1, 0], L_buf)
    return torch.from_numpy(codes).to(device)


def _machine_inputs(B, L_buf, k, m, seed, device, carry="zero"):
    """position arrays, the plain rescan and an initial state on the card:
    the init for fresh lanes, else a carry (zero, or random values that
    exercise the packing's wraparound)."""
    from brisk_tpu_torch.ops import enumerate as enum_ops
    from brisk_tpu_torch.ops import minimizer
    codes = _enum_codes(B, L_buf, seed, device)
    pa = minimizer.position_pipeline(codes, k, m)
    res = minimizer.windowed_get_minimizer_torch(pa, pa.fwd_k, k, m)
    rng = np.random.default_rng(seed + 1)
    fresh = torch.from_numpy(rng.random(B) < 0.5).to(device)
    if carry == "random":
        state0 = [torch.from_numpy(rng.integers(0, 8, B)).to(device)
                  for _ in range(7)]
        state0[3] = state0[3] % 2 == 0
        state0 = minimizer.MinimizerState(*state0)
    else:
        state0 = enum_ops.zero_carry(B, device)
    return pa, res, state0, fresh


def _assert_machine_equal(got, want):
    (rows_g, fin_g), (rows_w, fin_w) = got, want
    for g, w in zip(list(rows_g) + list(fin_g), list(rows_w) + list(fin_w)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("k,m,B,L_out,carry", [
    (31, 11, 33, 37, "zero"),        # B, L_out not multiples of 32 or 8
    (31, 11, 2048, 512, "zero"),     # the bench geometry
    (31, 11, 100, 1, "random"),      # one position
    (63, 21, 1000, 203, "random"),   # k=63, a carry in
    (31, 11, 1, 70, "zero"),         # one lane
    (31, 11, 2050, 33, "random"),    # 16-lane groups + 2; a tile + 1
    (63, 21, 1031, 20, "zero"),      # 8-lane groups + 7; under a tile
    (31, 11, 1024, 32, "random"),    # one whole tile
])
def test_state_scan_matches_plain_version(device, k, m, B, L_out, carry):
    from brisk_tpu_torch.ops import enumerate as enum_ops
    margin = k - 1
    pa, res, state0, fresh = _machine_inputs(B, margin + L_out, k, m,
                                             seed=B + L_out, device=device,
                                             carry=carry)
    want = enum_ops._state_machine_torch(state0, pa, res, fresh, k - m,
                                         margin)
    before = dict(kernels.LAUNCHES)
    got = enum_ops._state_machine(state0, pa, res, fresh, k - m, margin)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["state_scan"] == before["state_scan"] + 1
    assert kernels.LAUNCHES["rescan"] == before["rescan"]
    _assert_machine_equal(got, want)


def test_state_scan_carry_out_feeds_the_next_batch(device):
    """k=63 streaming over two batches: the kernel's final state is the
    carry in of the second batch, and both batches equal the plain
    version's run with its own carry."""
    from brisk_tpu_torch.ops import enumerate as enum_ops
    k, m, b, B, L_out = 63, 21, 14, 77, 150
    margin = k - 1
    rec = _enum_codes(B, margin + 2 * L_out, 63, device)
    fresh = torch.ones(B, dtype=torch.bool, device=device)
    ve = torch.full((B,), margin + L_out, dtype=torch.int32, device=device)
    runs = {}
    for name in ("plain", "kernel"):
        sm = enum_ops._state_machine
        if name == "plain":
            enum_ops._state_machine = enum_ops._state_machine_torch
        try:
            carry, out = enum_ops.zero_carry(B, device), []
            for i, codes in enumerate((rec[:, :margin + L_out],
                                       rec[:, L_out:].contiguous())):
                em, carry = enum_ops.enumerate_batch(
                    codes, fresh if i == 0 else ~fresh, ve, carry, k, m, b)
                out.append((em, carry))
        finally:
            enum_ops._state_machine = sm
        runs[name] = out
    for (ep, cp), (ek, ck) in zip(runs["plain"], runs["kernel"]):
        for f in ("boundary", "use_rc", "mini_idx", "mini_lo", "hash_lo",
                  "key", "bucket"):
            assert torch.equal(getattr(ep, f), getattr(ek, f)), f
        for x, y in zip(cp, ck):
            assert torch.equal(x, y)


@pytest.mark.parametrize("k_arg,m,R,L,with_unique", [
    (31, 11, 37, 130, True),       # R, L not multiples of the block
    (31, 11, 2048, 542, True),     # the bench geometry's batch
    (30, 11, 2048, 30, False),     # its fresh-lane init (k-1)
    (63, 21, 1024, 574, False),    # k=63: truncated offsets
    (62, 21, 1024, 62, False),
    (31, 11, 5000, 31, False),     # rekey rows (N, k)
    (63, 23, 5000, 63, False),     # rekey rows after reallocate
    (63, 23, 65536, 63, False),    # reallocate's rekey batch
    (62, 21, 3, 62, False),        # fewer positions than a block
])
def test_rescan_matches_plain_version(device, k_arg, m, R, L, with_unique):
    from brisk_tpu_torch.ops import minimizer
    pa = minimizer.position_pipeline(_enum_codes(R, L, R + L, device),
                                     k_arg, m)
    want = minimizer.windowed_get_minimizer_torch(pa, pa.fwd_k, k_arg, m,
                                                  with_unique)
    before = kernels.LAUNCHES["rescan"]
    got = minimizer.windowed_get_minimizer(pa, pa.fwd_k, k_arg, m,
                                           with_unique)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rescan"] == before + 1
    if with_unique:
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_enumerator_wrappers_check_inputs(device):
    from brisk_tpu_torch.ops import decycling, minimizer
    k, m, B, L_out = 31, 11, 40, 50
    pa, res, state0, fresh = _machine_inputs(B, k - 1 + L_out, k, m, 1,
                                             device)
    cand = tuple(pa.cand_hash) + tuple(pa.canon_m) + (pa.cand_is_rc,)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.state_scan(cand, tuple(res), tuple(state0), fresh.cpu(),
                           k - m, k - 1)
    with pytest.raises(TypeError):
        kernels.state_scan(cand[:5] + (cand[5].long(),), tuple(res),
                           tuple(state0), fresh, k - m, k - 1)
    strided = torch.zeros((B, 2 * (k - 1 + L_out)), dtype=torch.int64,
                          device=device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.state_scan((strided,) + cand[1:], tuple(res), tuple(state0),
                           fresh, k - m, k - 1)
    coef = decycling.coef_table(m, device)
    args = (pa.canon_m, pa.cand_hash, pa.scan_rev, pa.fwd_k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.rescan(*args, coef.cpu(), k, m)
    with pytest.raises(TypeError):
        kernels.rescan(*args, coef.float(), k, m)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.rescan((strided, pa.canon_m[1]), *args[1:], coef, k, m)
    assert kernels.LAUNCHES == before
    assert minimizer.windowed_get_minimizer(pa, pa.fwd_k, k, m) is not None
    assert kernels.LAUNCHES["rescan"] == before["rescan"] + 1


# -- the flush's kernels (kernels.positions, kernels.emit,
#    kernels.skl_rows) against their plain versions on the card ------------

def _assert_tuples_equal(got, want):
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _assert_tuples_equal(g, w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)


@pytest.mark.parametrize("k,m,R,L,init", [
    (31, 11, 37, 130, False),     # R, L not multiples of the block
    (31, 11, 2048, 542, False),   # the insert's batch
    (30, 11, 2048, 30, True),     # its fresh-lane init, strided rows
    (63, 21, 1024, 574, False),   # the k=63 streaming batch
    (62, 21, 1024, 62, True),
    (21, 11, 300, 90, False),
    (63, 23, 65536, 63, False),   # reallocate's rekey rows
    (31, 16, 50, 70, False),      # m = 16: the one-limb mixer's edge
    (31, 11, 300, 5, False),      # rows shorter than a thread's run of 8
    (30, 11, 300, 5, True),
    (31, 11, 300, 9, False),      # a run and one position
    (63, 21, 8, 128, False),      # one tile of 1,024 positions exactly
    (63, 21, 1, 1025, False),     # one tile and one position
    (31, 11, 5, 1100, False),     # rows of 1,100
])
def test_positions_matches_plain_version(device, k, m, R, L, init):
    from brisk_tpu_torch.ops import minimizer
    codes = _enum_codes(R, L + 7, R + L, device)
    codes = codes[:, :L] if init else codes[:, :L].contiguous()
    want = minimizer.position_pipeline_torch(codes, k, m)
    before = dict(kernels.LAUNCHES)
    got = minimizer.position_pipeline(codes, k, m)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["positions"] == before["positions"] + 1
    _assert_tuples_equal(tuple(got), tuple(want))


@pytest.mark.parametrize("k,m,b,B,L_out", [
    (31, 11, 8, 33, 37), (31, 11, 8, 2048, 512), (21, 11, 8, 100, 70),
    (63, 21, 14, 1024, 512), (63, 21, 14, 7, 1)])
def test_emit_matches_plain_version(device, k, m, b, B, L_out):
    from brisk_tpu_torch.ops import enumerate as enum_ops
    margin = k - 1
    pa, res, state0, fresh = _machine_inputs(B, margin + L_out, k, m,
                                             seed=B + L_out, device=device,
                                             carry="random")
    (_, rev, pos, mini, h), _ = enum_ops._state_machine_torch(
        state0, pa, res, fresh, k - m, margin)
    args = (rev, pos, mini, h, pa.fwd_k, pa.rc_k, k, m, b)
    want = enum_ops._emit_torch(*args)
    before = dict(kernels.LAUNCHES)
    got = enum_ops._emit(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["emit"] == before["emit"] + 1
    _assert_tuples_equal(got, want)


def _row_inputs(k, m, b, B, L_out, seed, device, windowed=True):
    """Emissions of one batch on the card with ragged valid spans and a
    hole inside a lane: rows_from_emissions' inputs (first_valid at
    valid_start)."""
    from brisk_tpu_torch.ops import enumerate as enum_ops
    margin = k - 1
    rng = np.random.default_rng(seed)
    codes = _enum_codes(B, margin + L_out, seed, device)
    ve = torch.from_numpy(rng.integers(margin + L_out // 2,
                                       margin + L_out + 1, B)).to(device)
    vs = torch.from_numpy(rng.integers(margin, margin + max(1, L_out // 4),
                                       B)).to(device)
    em, _ = enum_ops.enumerate_batch(
        codes, torch.ones(B, dtype=torch.bool, device=device), ve,
        enum_ops.zero_carry(B, device), k, m, b,
        valid_start=vs if windowed else None)
    pos = torch.arange(margin, margin + L_out, device=device)[None, :]
    valid = em.valid & (pos >= vs[:, None])
    valid[B // 2, L_out // 3: L_out // 3 + 5] = False
    first_valid = pos == vs[:, None]
    return (em.key, em.bucket, em.mini_idx, em.use_rc, valid, first_valid,
            em.boundary)


@pytest.mark.parametrize("k,m,b,B,L_out,row_cap", [
    (31, 11, 8, 2048, 512, 128),   # the insert's batch and row_cap
    (31, 11, 8, 33, 37, 4),        # overflow lanes; under one chunk
    (31, 11, 8, 40, 600, 4),       # three chunks, overflow
    (31, 11, 8, 40, 600, 600),     # every position has its slot
    (21, 11, 8, 64, 257, 16),      # a chunk and one position
    (63, 21, 14, 1024, 512, 128),  # the k=63 streaming batch: split runs
    (63, 21, 14, 9, 300, 4),
])
def test_skl_rows_matches_plain_version(device, k, m, b, B, L_out, row_cap):
    args = _row_inputs(k, m, b, B, L_out, B + L_out, device,
                       windowed=k <= 32)
    want = sklstore.rows_from_emissions_torch(*args, k, m, b, row_cap)
    before = dict(kernels.LAUNCHES)
    got = sklstore.rows_from_emissions(*args, k, m, b, row_cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["skl_rows"] == before["skl_rows"] + 1
    _assert_tuples_equal(got, want)
    if row_cap == 4:
        assert bool(want[3].any())


@pytest.mark.parametrize("k,m,b,B,L_out,row_cap", [
    (31, 11, 8, 64, 1, 4),         # lanes shorter than a thread's run of 2
    (31, 11, 8, 64, 3, 4),         # a run and one position
    (31, 11, 8, 64, 512, 512),     # one tile of 512 exactly
    (63, 21, 14, 32, 513, 4),      # one tile and one position
    (63, 21, 14, 16, 1100, 1100),  # three tiles, forward then backward
    (31, 11, 8, 16, 1100, 4),
])
def test_skl_rows_tiles_match_plain_version(device, k, m, b, B, L_out,
                                            row_cap):
    """The row assembly's runs and tiles at their edges, with lane 0 all
    invalid (no row: every slot padding)."""
    args = list(_row_inputs(k, m, b, B, L_out, B + L_out, device,
                            windowed=k <= 32))
    args[4] = args[4].clone()
    args[4][0] = False
    want = sklstore.rows_from_emissions_torch(*args, k, m, b, row_cap)
    before = dict(kernels.LAUNCHES)
    got = sklstore.rows_from_emissions(*args, k, m, b, row_cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["skl_rows"] == before["skl_rows"] + 1
    _assert_tuples_equal(got, want)
    assert not bool(want[3][0]) and bool((want[0][0] == 0xFFFFFFFF).all())


@pytest.mark.parametrize("k,m,b,windowed", [(31, 11, 8, True),
                                           (63, 21, 14, False)])
def test_enumerate_batch_on_card_matches_cpu(device, k, m, b, windowed):
    """enumerate_batch through the five enumerator kernels equals the CPU
    port's (the plain versions) field for field, replay included."""
    from brisk_tpu_torch.ops import enumerate as enum_ops
    B, L_out, margin = 300, 200, k - 1
    rng = np.random.default_rng(k)
    codes = _enum_codes(B, margin + L_out, k, "cpu")
    fresh = torch.from_numpy(rng.random(B) < 0.7)
    ve = torch.from_numpy(rng.integers(margin, margin + L_out + 1, B))
    vs = (torch.from_numpy(rng.integers(margin, margin + 60, B))
          if windowed else None)
    carry = enum_ops.zero_carry(B)
    want, want_fin = enum_ops.enumerate_batch(codes, fresh, ve, carry, k, m,
                                              b, valid_start=vs)
    before = dict(kernels.LAUNCHES)
    got, got_fin = enum_ops.enumerate_batch(
        codes.to(device), fresh.to(device), ve.to(device),
        enum_ops.zero_carry(B, device), k, m, b,
        valid_start=None if vs is None else vs.to(device))
    torch.cuda.synchronize()
    for name in ("positions", "rescan", "state_scan", "emit"):
        assert kernels.LAUNCHES[name] > before[name], name
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        for x, y in zip(g, w) if f == "replay" else ((g, w),):
            assert torch.equal(x.cpu(), y), f
    for x, y in zip(got_fin, want_fin):
        assert torch.equal(x.cpu(), y)


def test_insert_on_card_matches_cpu(device):
    """One k=31 insert (windowed lanes with repairs and an overflow: the
    repair fixture's record at batch 16, window 64) gives the CPU port's
    arena on the card, and went through all six kernels' enumerator and
    row paths."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/repair.fa"
        _write_repair_input(path)
        built = []
        for dev in ("cpu", device):
            before = dict(kernels.LAUNCHES)
            br = Brisk(Parameters(31, 11, 8), batch=16, window=64,
                       device=dev)
            br.insert_file(path)
            br.insert_file("data/test.fa")
            br._drain()
            built.append((br, _rows(br.skl), dict(kernels.LAUNCHES)))
        (cpu, cpu_rows, _), (card, card_rows, after) = built
        _assert_rows_equal(cpu_rows, card_rows)
        for name in ("positions", "emit", "skl_rows", "state_scan",
                     "rescan"):
            assert after[name] > before[name], name
        assert card.n_emitted == cpu.n_emitted
        assert card.counts_dict() == cpu.counts_dict()


def test_flush_wrappers_check_inputs(device):
    from brisk_tpu_torch.ops import decycling, minimizer
    k, m, b = 31, 11, 8
    codes = _enum_codes(20, 80, 3, device)
    coef = decycling.coef_table(m, device)
    pa = minimizer.position_pipeline_torch(codes, k, m)
    args = _row_inputs(k, m, b, 20, 60, 1, device)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError):
        kernels.positions(codes.to(torch.int32), coef, k, m)
    with pytest.raises(ValueError, match="adjacent"):
        kernels.positions(codes[:, ::2], coef, k, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.positions(codes, coef.cpu(), k, m)
    i64 = torch.zeros((20, 50), dtype=torch.int64, device=device)
    rev = torch.zeros((20, 50), dtype=torch.bool, device=device)
    with pytest.raises(TypeError):
        kernels.emit(rev.long(), i64, i64, i64, pa.fwd_k, pa.rc_k, k, m, b)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.emit(rev, i64, i64, i64,
                     (pa.fwd_k[0].t().contiguous().t(),)
                     + pa.fwd_k[1:], pa.rc_k, k, m, b)
    from brisk_tpu_torch.index import sklstore
    _, s_max, _, nw = sklstore.skl_dims(k, m, b)
    dims = (s_max, nw, True)
    with pytest.raises(TypeError):
        kernels.skl_rows(args[0].int(), *args[1:], k, m, b, 8, *dims)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.skl_rows(*args[:4], args[4].cpu(), *args[5:], k, m, b, 8,
                         *dims)
    assert kernels.LAUNCHES == before


# -- the run scan (csrc/run_scan.cu: kernels.join_scan, kernels.run_totals)
#    against its plain versions on the card --------------------------------

# (slots, longest run): ragged S (one slot, a group cut short, one past a
# group, tiles of 32 to 2,048 slots cut short); runs of 1-3 slots and runs
# longer than a tile (tiles without a run start)
SCAN_SHAPES = [(1, 3), (31, 3), (33, 40), (1000, 3), (4097, 300),
               ((1 << 17) + 1, 3), ((1 << 20) + 3, 5000),
               ((1 << 23) + 17, 3), ((1 << 23) + 17, 5000)]


@pytest.mark.parametrize("W", [3, 6])
@pytest.mark.parametrize("n,max_run", SCAN_SHAPES)
def test_join_scan_matches_plain_version(device, n, max_run, W):
    """kernels.join_scan equals sklstore._join_scan_torch element for
    element: index counts past 2^31 (run sums past 2^32), query liveness
    0, 1 and 2, runs across tiles."""
    from run_scan_cases import join_inputs
    words, pay = join_inputs(n, W, max_run, seed=n + W)
    want = sklstore._join_scan_torch(words, pay)
    before = kernels.LAUNCHES["join_scan"]
    got = kernels.join_scan(words.to(device), pay.to(device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["join_scan"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n,max_run", SCAN_SHAPES)
def test_run_totals_matches_plain_version(device, n, max_run):
    """kernels.run_totals equals store._run_totals_torch: each run's u32
    total at its last column (sums past 2^32 masked) and every column's
    run index."""
    from brisk_tpu_torch.index import store
    from run_scan_cases import run_inputs
    data, first = run_inputs(n, max_run, seed=n)
    want = store._run_totals_torch(data, first)
    before = kernels.LAUNCHES["run_totals"]
    got = kernels.run_totals(data.to(device), first.to(device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["run_totals"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# look-back-stressing shapes made on the card (bench_run_scan.inputs: name,
# kernel, slots, W, longest run): one run over 2^26 slots (no tile after
# the first starts a run, so every look-back of run_totals and of the join
# reads back to a prefix), and run starts every ~100,000 slots
LOOKBACK_SHAPES = [("one-run", "join_scan", 1 << 26, 3, 1 << 26),
                   ("one-run", "run_totals", 1 << 26, 1, 1 << 26),
                   ("sparse-starts", "join_scan", (1 << 26) + 5, 6, 199_999),
                   ("sparse-starts", "run_totals", (1 << 26) + 5, 1,
                    199_999)]


@pytest.mark.parametrize("name,kernel,n,W,max_run", LOOKBACK_SHAPES)
def test_run_scan_repeats_are_bitwise_equal(device, name, kernel, n, W,
                                            max_run):
    """Five calls of each run-scan kernel at a many-tile shape whose
    look-backs run long: every output equals the plain version's, bit for
    bit (a reader that saw a status before its value would give a stale
    carry on some call)."""
    from brisk_tpu_torch import bench_run_scan
    row = bench_run_scan.measure(name, kernel, n, W, max_run, device,
                                 timed=False, repeats=5)
    assert row["max_abs_err"] == 0 and row["repeats"] == 5


def test_run_scan_replays_in_a_cuda_graph(device):
    """kernels.join_scan and kernels.run_totals captured in one CUDA graph:
    two replays, the inputs rewritten in place before the second, each
    give the plain version's result (the call zeroes its tile statuses on
    its stream, so a replay starts afresh)."""
    from brisk_tpu_torch import bench_run_scan
    from brisk_tpu_torch.index import store
    n = (1 << 20) + 3
    sets = [(bench_run_scan.inputs("join_scan", n, 3, 40, device, seed=s),
             bench_run_scan.inputs("run_totals", n, 1, 300, device, seed=s))
            for s in (1, 2)]
    (words, pay), (data, first) = (tuple(t.clone() for t in a)
                                   for a in sets[0])
    kernels.join_scan(words, pay)  # build and load before the capture
    kernels.run_totals(data, first)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(kernels.LAUNCHES)
    with torch.cuda.graph(graph):
        parts = kernels.join_scan(words, pay)
        totals = kernels.run_totals(data, first)
    assert kernels.LAUNCHES["join_scan"] == before["join_scan"] + 1
    assert kernels.LAUNCHES["run_totals"] == before["run_totals"] + 1
    for (j_args, r_args) in sets:
        for dst, src in zip((words, pay, data, first), j_args + r_args):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(parts, sklstore._join_scan_torch(*j_args))
        for g, w in zip(totals, store._run_totals_torch(*r_args)):
            assert torch.equal(g, w)


def test_join_and_compact_on_card_launch_the_run_scan(device):
    """_query_join_partials and store.compact on CUDA tensors go through
    the run scan's kernels and equal their CPU results."""
    from brisk_tpu_torch import _u32
    from brisk_tpu_torch.index import store
    rng = np.random.default_rng(3)
    pool = rng.integers(0, 1 << 31, (3, 900), dtype=np.uint32)
    ik = pool[:, rng.integers(0, 900, 5000)]
    qk = pool[:, rng.integers(0, 900, 3000)]
    qk[:, :50] = 0xFFFFFFFF
    ic = torch.from_numpy(rng.integers(0, 1 << 32, 5000, dtype=np.int64))
    ql = torch.from_numpy((rng.random(3000) < 0.9).astype(np.int64))
    ql[:50] = 0
    args = (_u32.from_np(ik, "cpu"), ic, _u32.from_np(qk, "cpu"), ql)
    want = sklstore._query_join_partials(*args)
    before = dict(kernels.LAUNCHES)
    got = sklstore._query_join_partials(*(a.to(device) for a in args))
    assert torch.equal(got.cpu(), want)
    assert kernels.LAUNCHES["join_scan"] == before["join_scan"] + 1
    keys = np.concatenate([ik, np.full((3, 3192), 0xFFFFFFFF, np.uint32)],
                          1)
    data = torch.cat([ic, torch.zeros(3192, dtype=torch.int64)])
    cpu = store.compact(store.IndexState(_u32.from_np(keys, "cpu"), data,
                                         0, 5000))
    card = store.compact(store.IndexState(_u32.from_np(keys, device),
                                          data.to(device), 0, 5000))
    assert kernels.LAUNCHES["run_totals"] == before["run_totals"] + 1
    assert card.n_sorted == cpu.n_sorted and 0 < cpu.n_sorted < 5000
    assert torch.equal(card.keys.cpu(), cpu.keys)
    assert torch.equal(card.data.cpu(), cpu.data)


def test_run_scan_wrappers_check_inputs(device):
    """Device, dtype, shape and contiguity: each wrong input raises before
    a launch."""
    words = torch.zeros((3, 100), dtype=torch.int64, device=device)
    pay = torch.zeros(100, dtype=torch.int64, device=device)
    first = torch.ones(100, dtype=torch.bool, device=device)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.join_scan(words, pay.cpu())
    with pytest.raises(TypeError):
        kernels.join_scan(words.int(), pay)
    with pytest.raises(ValueError, match="expected shape"):
        kernels.join_scan(words, pay[:99])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.join_scan(words.t().contiguous().t(), pay)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.join_scan(torch.zeros((7, 100), dtype=torch.int64,
                                      device=device), pay)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.run_totals(pay, first.cpu())
    with pytest.raises(TypeError):
        kernels.run_totals(pay, first.long())
    with pytest.raises(ValueError, match="expected shape"):
        kernels.run_totals(pay, first[:50])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.run_totals(torch.zeros(200, dtype=torch.int64,
                                       device=device)[::2], first)
    assert kernels.LAUNCHES == before
    empty = torch.zeros((3, 0), dtype=torch.int64, device=device)
    assert torch.equal(kernels.join_scan(empty, pay[:0]).cpu(),
                       torch.zeros(256, dtype=torch.int64))
    assert kernels.LAUNCHES == before


# -- the insert programs as CUDA graph replays (index.flush_graph) --------

@pytest.fixture
def graphs(device):
    """The flush graphs' cache, emptied before and after the test."""
    from brisk_tpu_torch.index import flush_graph
    flush_graph.clear()
    yield flush_graph
    flush_graph.clear()
    torch.cuda.empty_cache()


def _graph_records(seed: int = 11) -> list:
    """Random records from numpy (one long, several 10 kb and short ones)
    and the repair fixture's record, whose windows fail their
    certificate."""
    import random
    rng = np.random.default_rng(seed)
    recs = [rng.integers(0, 4, n, dtype=np.uint8)
            for n in (60_000, 10_000, 31, 500, 10_000, 45_000)]
    r = random.Random(5)

    def rs(n):
        return "".join(r.choice("ACGT") for _ in range(n))

    recs.insert(2, rs(300) + "ACGTTGCA" * 200 + rs(300)
                + "AAAAAAAAAAAAC" * 80 + rs(300))
    return recs


def _flat_stacks(device, batch=64, window=128, stack=2, n=8):
    """The first n packed flushes of _graph_records at a Brisk's k=31
    geometry on the card: ([(chunk4, valid_start, valid_end)], static)."""
    from brisk_tpu_torch.io import windows
    geo = Brisk(Parameters(31, 11, 8), batch=batch, window=window,
                stack=stack, device=device)
    packer = windows.WindowPacker(31, 11, batch, l_out=geo.window)
    stacks = []
    for fl in packer.pack_flat(iter(_graph_records()), stack):
        stacks.append(tuple(torch.from_numpy(x).to(device) for x in (
            fl.chunk4, fl.valid_start.reshape(stack, batch),
            fl.valid_end.reshape(stack, batch))))
        if len(stacks) == n:
            break
    assert len(stacks) == n
    return stacks, (31, 11, 8, geo.skl_row_cap, packer.l_buf, packer.useful)


def _k31_arena(device, static, flushes: int):
    nw = sklstore.skl_dims(31, 11, 8)[3]
    rows = flushes * 2 * 64 * static[3]
    return sklstore.empty(1 << max(14, rows.bit_length()), 1 << 14, nw,
                          device)


def _assert_same_outputs(a, c) -> None:
    """Two insert-program tuples (or parts) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == c.dtype and torch.equal(a, c)
    else:
        assert len(a) == len(c)
        for x, y in zip(a, c):
            _assert_same_outputs(x, y)


def test_flush_graph_matches_eager_over_many_pending_flushes(device,
                                                             graphs):
    """Eight k=31 flushes through the graph runner against the eager
    program on the same inputs, the chain carried: every flush's flags,
    end states, counts, n_rows and chain are held until all eight have
    run (more than Brisk._pending's depth of 4, so outputs that a later
    replay overwrote would show), then compared bit for bit, as are the
    arenas' whole columns. One capture, seven replays after it; some
    lanes fail their certificate."""
    from brisk_tpu_torch.index import pipeline
    stacks, static = _flat_stacks(device)
    eager_skl = _k31_arena(device, static, len(stacks))
    graph_skl = sklstore.SklState(*(t.clone() for t in eager_skl))
    e_chain = g_chain = pipeline.zero_chain(device)
    eager, graph = [], []
    for st in stacks:
        e = pipeline.insert_flat_sklnative(eager_skl, *st, e_chain, *static)
        g = graphs.insert_flat(graph_skl, *st, g_chain, *static)
        eager_skl, e_chain, graph_skl, g_chain = e[0], e[6], g[0], g[6]
        eager.append(e[1:])
        graph.append(g[1:])
    torch.cuda.synchronize()
    for e, g in zip(eager, graph):
        _assert_same_outputs(e, g)
    _assert_same_outputs(tuple(eager_skl), tuple(graph_skl))
    assert any(bool(((e[2] & 1) == 0).any()) for e in eager)
    (info,) = graphs.graphs()
    assert info["program"] == "flat" and info["replays"] == len(stacks)
    assert info["pool_bytes"] > 0


def test_flush_graph_after_the_arena_grows(device, graphs):
    """A flush after ensure_room has grown the arena (new column tensors)
    replays the same graph, and the grown arena equals the eager
    program's after the same growth."""
    from brisk_tpu_torch.index import pipeline
    stacks, static = _flat_stacks(device, n=3)
    eager_skl = _k31_arena(device, static, 1)
    graph_skl = sklstore.SklState(*(t.clone() for t in eager_skl))
    e_chain = g_chain = pipeline.zero_chain(device)
    rcap = eager_skl.bucket.shape[0]
    for i, st in enumerate(stacks):
        if i:
            need = rcap  # doubles the capacity
            eager_skl = sklstore.ensure_room(eager_skl, need)
            graph_skl = sklstore.ensure_room(graph_skl, need)
        e = pipeline.insert_flat_sklnative(eager_skl, *st, e_chain, *static)
        g = graphs.insert_flat(graph_skl, *st, g_chain, *static)
        _assert_same_outputs(e, g)
        eager_skl, e_chain, graph_skl, g_chain = e[0], e[6], g[0], g[6]
    assert graph_skl.bucket.shape[0] > rcap
    (info,) = graphs.graphs()
    assert info["replays"] == len(stacks)


def test_flush_graph_shared_by_a_brisk_and_its_query_shadow(device,
                                                            graphs,
                                                            tmp_path):
    """Two Brisk objects of one geometry share one graph: the index and
    query_file's shadow (whose flushes replay it, no new capture); the
    index and the query total equal the CPU port's."""
    from brisk_tpu_torch import bench
    path = bench.synth_path(str(tmp_path), 60_000)
    geo = dict(batch=64, window=128, stack=2)
    cpu = Brisk(Parameters(31, 11, 8), device="cpu", **geo)
    card = Brisk(Parameters(31, 11, 8), device=device, **geo)
    for br in (cpu, card):
        br.insert_file(path)
        br._drain()
    _assert_rows_equal(_rows(cpu.skl), _rows(card.skl))
    (before,) = graphs.graphs()
    total = card.query_file(path)
    (after,) = graphs.graphs()
    assert after["replays"] == 2 * before["replays"] > 0
    assert total == cpu.query_file(path) > 0
    assert card.n_emitted == cpu.n_emitted


def test_flush_graph_stream_k63_matches_eager(device, graphs):
    """The k=63 streaming program through its graph against the eager
    program, carry carried over four flushes: every output and the arena,
    bit for bit, all outputs held to the end."""
    from brisk_tpu_torch.io import fasta
    from brisk_tpu_torch.index import pipeline
    from brisk_tpu_torch.ops import enumerate as enum_ops
    k, m, b = 63, 21, 14
    B, l_new, S = 32, 256, 2
    packer = fasta.BatchPacker(k, B, l_new)
    batches = list(packer.pack(iter(_graph_records())))
    flushes = []
    for i in range(0, 4 * S, S):
        flushes.append(tuple(torch.from_numpy(np.stack(
            [getattr(bt, f) for bt in batches[i:i + S]])).to(device)
            for f in ("codes", "fresh", "valid_end")))
    nw = sklstore.skl_dims(k, m, b)[3]
    eager_skl = sklstore.empty(1 << 17, 1 << 14, nw, device)
    graph_skl = sklstore.SklState(*(t.clone() for t in eager_skl))
    e_carry = g_carry = enum_ops.zero_carry(B, device)
    eager, graph = [], []
    for fl in flushes:
        e = pipeline.insert_stream_sklnative(eager_skl, *fl, e_carry, k, m,
                                             b, l_new)
        g = graphs.insert_stream(graph_skl, *fl, g_carry, k, m, b, l_new)
        eager_skl, e_carry, graph_skl, g_carry = e[0], e[3], g[0], g[3]
        eager.append(e[1:])
        graph.append(g[1:])
    for e, g in zip(eager, graph):
        _assert_same_outputs(e, g)
    _assert_same_outputs(tuple(eager_skl), tuple(graph_skl))
    assert int(graph_skl.n_rows) > 0
    (info,) = graphs.graphs()
    assert info["program"] == "stream" and info["replays"] == len(flushes)


def test_flush_graph_repair_fixture(device, graphs, tmp_path):
    """The repair fixture (batch 16, window 64) through the graph: its
    lanes that fail their certificate are repaired from the cloned flags
    and end states, an overflowing lane re-runs, and the arena, counters
    and the query total (199,764) equal the CPU port's."""
    import random
    r = random.Random(5)

    def rs(n):
        return "".join(r.choice("ACGT") for _ in range(n))

    path = tmp_path / "repair.fa"
    path.write_text(">repair\n" + rs(300) + "ACGTTGCA" * 200 + rs(300)
                    + "AAAAAAAAAAAAC" * 80 + rs(300) + "\n")
    built = []
    for dev in ("cpu", device):
        br = Brisk(Parameters(31, 11, 8), batch=16, window=64, device=dev)
        br.insert_file(str(path))
        br._drain()
        built.append((br, _rows(br.skl)))
    (cpu, cpu_rows), (card, card_rows) = built
    _assert_rows_equal(cpu_rows, card_rows)
    for name in ("n_emitted", "n_superkmers", "n_repaired_windows",
                 "n_repair_batches", "n_skl_overflows"):
        assert getattr(card, name) == getattr(cpu, name), name
    assert (card.n_emitted, card.n_repaired_windows,
            card.n_skl_overflows) == (3510, 30, 1)
    assert card.query_file(str(path)) == 199_764
    assert graphs.graphs()[0]["replays"] > 0


def test_flush_graph_launches_equal_the_eager_programs(device, graphs):
    """kernels.LAUNCHES over N replays (after the capture) equals its
    count over N eager flushes of the same inputs: each replay adds the
    launches its capture recorded."""
    from brisk_tpu_torch.index import pipeline
    stacks, static = _flat_stacks(device, n=4)
    skl = _k31_arena(device, static, 2 * len(stacks))
    chain = pipeline.zero_chain(device)
    graphs.insert_flat(skl, *stacks[0], chain, *static)  # the capture
    counted = []
    for run in (pipeline.insert_flat_sklnative, graphs.insert_flat):
        before = dict(kernels.LAUNCHES)
        ch = chain
        for st in stacks:
            out = run(skl, *st, ch, *static)
            skl, ch = out[0], out[6]
        counted.append(kernels.launch_delta(before, kernels.LAUNCHES))
    eager, graph = counted
    assert graph == eager
    for name in ("positions", "rescan", "state_scan", "emit", "skl_rows"):
        assert eager[name] >= len(stacks), name


def test_flush_graph_failed_capture_raises(device, graphs, monkeypatch):
    """A body that reads the host while capturing (a synchronize) fails
    its capture: insert_flat raises, caches no graph and does not run the
    flush eagerly instead."""
    from brisk_tpu_torch.index import pipeline
    stacks, static = _flat_stacks(device, n=1)
    prog = graphs.PROGRAMS["flat"]

    def reads_the_host(*args):
        out = pipeline.flat_flush_body(*args)
        torch.cuda.synchronize()
        return out

    monkeypatch.setitem(graphs.PROGRAMS, "flat",
                        prog._replace(body=reads_the_host))
    skl = _k31_arena(device, static, 1)
    with pytest.raises(RuntimeError):
        graphs.insert_flat(skl, *stacks[0], pipeline.zero_chain(device),
                           *static)
    assert graphs.graphs() == []
    assert int(skl.n_rows) == 0
    torch.cuda.synchronize()


# -- the payload insert and the sharded step as CUDA graph replays --------

def _window_batches(lanes: int, window: int, kmb=(31, 11, 8)):
    """Every window batch (io.windows) of _graph_records at lanes x
    window, and the packer."""
    from brisk_tpu_torch.io import windows
    packer = windows.WindowPacker(kmb[0], kmb[1], lanes, l_out=window)
    return list(packer.pack(iter(_graph_records()))), packer


def _payload_program(device, n: int, S: int = 2):
    """The payload program at a BriskData's geometry (k=31, width 2, 64
    lanes, window 128, stack S): (eager, graph) as (state, stack i,
    chain) -> the program's tuple, the n staged stacks, a fresh state of
    1.5 stacks' columns, the chain's index in the tuple and the room
    rule BriskData._room_for applies before flush i, (state, i) ->
    state."""
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.index import flush_graph, payload, pipeline
    bd = BriskData(Parameters(31, 11, 8), width=2, batch=64, window=128,
                   stack=S, device=device)
    batches, packer = _window_batches(64, bd.window)
    assert len(batches) >= n * S
    stacks = [bd._stage(packer, batches[i:i + S])
              for i in range(0, n * S, S)]
    cols = S * 64 * packer.l_out
    static = (31, 11, 8, 2)

    def room(state, i):
        if state.n_used + cols > state.keys.shape[1]:
            state = payload.compact(state, bd.kinds)
        return payload.ensure_room(state, cols)

    return ((lambda st, i, ch: pipeline.insert_windows_payload(
                st, *stacks[i], ch, *static)),
            (lambda st, i, ch: flush_graph.insert_payload(
                st, *stacks[i], ch, *static)),
            stacks, payload.empty(cols * 3 // 2, bd.W, 2, device), 4, room)


def _sharded_program(device, n: int, S: int = 2, route_cap: int = 2):
    """The sharded step at a ShardedBrisk's geometry (k=31, 8 shards x 16
    lanes, window 128, stack S, a route cap that spills): as
    _payload_program, the room rule a sharded_skl_grow doubling the
    arenas before the third stack."""
    from brisk_tpu_torch.index import flush_graph
    from brisk_tpu_torch.parallel import sharded
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    sb = ShardedBrisk(Parameters(31, 11, 8), n_devices=8, batch_per_shard=16,
                      window=128, stack=S, skl_route_cap=route_cap,
                      device=device)
    from brisk_tpu_torch.io import windows
    packer = windows.WindowPacker(31, 11, sb.B, l_out=sb.window)
    laid = list(packer.record_stacks(_graph_records(), S))
    assert laid[n - 1].batches[-1].rec[-1] >= 0  # n full stacks
    stacks = [sb._stage(st) for st in laid[:n]]
    tail = (31, 11, 8, sb.mesh, sb.skl_row_cap, route_cap)

    def room(skl, i):
        if i == 2:
            return sharded.sharded_skl_grow(skl, 2 * skl.bucket.shape[1],
                                            sb.mesh)
        return skl

    return ((lambda st, i, ch: sharded.sharded_insert_windows_sklonly(
                st, *stacks[i], ch, *tail)),
            (lambda st, i, ch: flush_graph.insert_sharded(
                st, *stacks[i], ch, *tail)),
            stacks, sb.skl, 7, room)


PROGRAMS = {"payload": _payload_program, "sharded": _sharded_program}


def _clone_state(state):
    return type(state)(*(x.clone() if isinstance(x, torch.Tensor) else x
                         for x in state))


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_payload_and_sharded_graphs_match_eager(device, graphs, program):
    """Eight payload flushes (the log compacted and grown on the way, as
    BriskData._room_for does) or four sharded steps at a spilling route
    cap (the arenas grown by sharded_skl_grow before the third) through
    the graph runner against the eager program on the same inputs, the
    chain carried: every flush's outputs held until all have run (more
    than any caller keeps, so outputs a later replay overwrote would
    show), then compared bit for bit, as are the states. One capture,
    a replay a flush."""
    from brisk_tpu_torch.index import pipeline
    n = 8 if program == "payload" else 4
    eager, graph, stacks, state, at, room = PROGRAMS[program](device, n)
    runs = []
    for fn in (eager, graph):
        st, ch, outs, rooms = _clone_state(state), (
            pipeline.zero_chain(device)), [], []
        for i in range(n):
            st = room(st, i)
            rooms.append(st.keys.shape[1] if program == "payload"
                         else st.bucket.shape[1])
            out = fn(st, i, ch)
            st, ch = out[0], out[at]
            outs.append(out[1:])
        runs.append((st, outs, rooms))
    torch.cuda.synchronize()
    (e_st, e_outs, e_rooms), (g_st, g_outs, g_rooms) = runs
    for e, g in zip(e_outs, g_outs):
        _assert_same_outputs(e, g)
    _assert_same_outputs(tuple(x for x in e_st if isinstance(x,
                                                             torch.Tensor)),
                         tuple(x for x in g_st if isinstance(x,
                                                             torch.Tensor)))
    assert e_rooms == g_rooms and e_rooms[-1] > e_rooms[0]  # grown
    if program == "payload":
        assert (e_st.n_used, e_st.n_sorted) == (g_st.n_used, g_st.n_sorted)
        assert g_st.n_sorted > 0  # compacted on the way
    else:
        assert sum(int(o[2]) for o in g_outs) > 0  # rows spilled
        assert int(g_st.n_rows.sum()) > 0
    cert_at = 1 if program == "payload" else 3
    assert any(bool((~o[cert_at]).any()) for o in g_outs)  # uncertified
    (info,) = graphs.graphs()
    assert info["program"] == program and info["replays"] == n
    assert info["pool_bytes"] > 0


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_payload_and_sharded_graph_launches_equal_eager(device, graphs,
                                                        program):
    """kernels.LAUNCHES over the replays (after the capture) equals its
    count over eager flushes of the same inputs."""
    from brisk_tpu_torch.index import pipeline
    eager, graph, stacks, state, at, room = PROGRAMS[program](device, 3)
    graph(room(_clone_state(state), 0), 0, pipeline.zero_chain(device))
    counted = []
    for fn in (eager, graph):
        st, ch = _clone_state(state), pipeline.zero_chain(device)
        before = dict(kernels.LAUNCHES)
        for i in range(len(stacks)):
            out = fn(room(st, i), i, ch)
            st, ch = out[0], out[at]
        counted.append(kernels.launch_delta(before, kernels.LAUNCHES))
    assert counted[1] == counted[0]
    names = ("positions", "rescan", "state_scan", "emit")
    if program == "sharded":
        names += ("skl_rows",)
    for name in names:
        assert counted[0][name] >= len(stacks), name
    assert "skl_rows" in counted[0] or program == "payload"


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_payload_and_sharded_failed_capture_raises(device, graphs,
                                                   monkeypatch, program):
    """A body that reads the host while capturing fails its capture: the
    entry point raises, caches no graph and does not run the flush
    eagerly instead."""
    from brisk_tpu_torch.index import pipeline
    prog = graphs.PROGRAMS[program]

    def reads_the_host(*args):
        out = prog.body(*args)
        torch.cuda.synchronize()
        return out

    monkeypatch.setitem(graphs.PROGRAMS, program,
                        prog._replace(body=reads_the_host))
    eager, graph, stacks, state, at, room = PROGRAMS[program](device, 1)
    st = room(state, 0)
    with pytest.raises(RuntimeError):
        graph(st, 0, pipeline.zero_chain(device))
    assert graphs.graphs() == []
    if program == "payload":
        assert st.n_used == 0 and bool((st.keys == -1).all())
    else:
        assert int(st.n_rows.sum()) == 0
    torch.cuda.synchronize()


def test_sharded_graph_refuses_a_mesh_of_several_processes(device, graphs):
    """insert_sharded on the card refuses a mesh whose group is set (its
    collectives are not captured); ShardedBrisk runs that mesh's eager
    program."""
    from brisk_tpu_torch.parallel import multihost
    eager, graph, stacks, state, at, room = _sharded_program(device, 1)
    mesh = multihost.Mesh(8, device, n_proc=2, pid=0, group=object())
    with pytest.raises(ValueError, match="several processes"):
        graphs.insert_sharded(state, *stacks[0], None, 31, 11, 8, mesh,
                              32, 2)
    assert graphs.graphs() == []


def test_briskdata_and_sharded_flushes_each_replay_the_graph(device, graphs,
                                                             tmp_path,
                                                             monkeypatch):
    """BriskData and ShardedBrisk (8 shards on the card) insert a file
    with one graph replay a flush, and equal their CPU counterparts."""
    from brisk_tpu_torch import bench
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.index import payload
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    path = bench.synth_path(str(tmp_path), 60_000)
    flushes = []
    for cls, name in ((BriskData, "_flush"), (ShardedBrisk, "_flush_stack")):
        run = getattr(cls, name)

        def counted(self, *args, _run=run, _cls=cls):
            flushes.append(_cls.__name__)
            return _run(self, *args)

        monkeypatch.setattr(cls, name, counted)
    built = {}
    for dev in ("cpu", device):
        bd = BriskData(Parameters(31, 11, 8), batch=64, window=128, stack=2,
                       device=dev)
        sb = ShardedBrisk(Parameters(31, 11, 8), n_devices=8,
                          batch_per_shard=8, window=128, stack=2, device=dev)
        for idx in (bd, sb):
            idx.insert_file(path)
        built[str(dev)] = (payload.to_numpy(bd.state), _arena_np(sb), bd,
                           sb)
    (cpu_p, cpu_s, cpu_bd, cpu_sb), (card_p, card_s, card_bd, card_sb) = (
        built["cpu"], built[str(device)])
    for f in ("keys", "data", "n_sorted", "n_used"):
        assert np.array_equal(cpu_p[f], card_p[f]), f
    for f, a in cpu_s.items():
        assert np.array_equal(a, card_s[f]), f
    assert card_bd.n_emitted == cpu_bd.n_emitted > 0
    assert card_sb.n_emitted == cpu_sb.n_emitted == card_bd.n_emitted
    info = {g["program"]: g["replays"] for g in graphs.graphs()}
    n_card = len(flushes) // 2
    assert info == {"payload": flushes[n_card:].count("BriskData"),
                    "sharded": flushes[n_card:].count("ShardedBrisk")}
    assert min(info.values()) > 0
