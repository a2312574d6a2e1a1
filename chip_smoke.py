#!/usr/bin/env python3
"""Smoke run of brisk_tpu_torch on one CUDA card: the quickest proof that
the port builds, agrees with its references and serves end to end.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code
is non-zero and no final `ok` line is printed):

1. the card's name and power limit; build every CUDA kernel.
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at the shapes the main path gives it: the span expansion in both
   layouts at the four span shapes of brisk_tpu_torch.bench_expand
   (finalize k=31 and k=63, consolidate, expand_device), on insert-shaped
   rows and on rows with any meta, plus small and ragged spans; per shape
   the kernel's time, its bound and share of it, a fill_ of the output,
   the plain version and, row-major, the old path (J-major + transpose).
   Then the enumerator's five kernels, the position pipeline
   (positions), the get_minimizer rescan (rescan), the state machine
   (state_scan), the emission epilogue (emit) and the super-k-mer row
   assembly (skl_rows), at ragged shapes (lanes, tiles and blocks cut
   short; the position pipeline and the rescan also over the fresh-lane
   init's strided rows and reallocate's rekey batch, the position
   pipeline timed there too; the rows with ragged valid spans and
   overflowing lanes) and at the shapes of the insert's batch (bench
   geometry) and the k=63 streaming batch, with their times, plain
   versions' times and bounds (brisk_tpu_torch.bench_enumerate). Then
   the run scan's two kernels (csrc/run_scan.cu), the query join's scan
   (join_scan) and compact's run totals (run_totals), at ragged shapes
   (one slot, groups and tiles cut short, runs longer than a tile), at
   shapes that stress their look-back (one run over 2^26 slots, run
   starts every ~100,000 slots), each shape called 5 times and every
   call held to the plain version bit for bit, under a wall-clock guard
   that ends the run with every thread's traceback, and,
   timed beside their plain versions, the library call pair cumsum +
   cummax and their bounds, at the query joins' and the rekey
   compaction's shapes (brisk_tpu_torch.bench_run_scan).
3. fixture parity on the card: counts_dict() equals the pure-Python
   oracle (pyref.count_fasta) on data/test.fa, data/debug_test.fa and a
   fixture that exercises the exact repair and overflow paths.
4. the deployment: k=31 m=11 b=8 counter on a 50 Mb synthetic genome
   (5,000 records of 10 kb, brisk_tpu_torch.io.synth.write_synth, seed
   1234) through warmup -> insert_file -> finalize, then stats, point
   lookups and query_file, checked against the reference's totals.
   flush-graph: the flush program as Brisk runs it on the card, one CUDA
   graph replay a flush (index.flush_graph), against the eager program
   (pipeline.insert_flat_sklnative) on the deployment's first 6 flushes:
   every flush's flags, end states, counts, n_rows and chain held to the
   end (more flushes than Brisk._pending's depth of 4) and the arenas'
   whole columns, bit for bit; the flush wall of each path; one flush of
   each under torch.profiler (trace_insert.traced_call): the host's
   launch and copy calls and the kernels the device ran; the cached
   graphs (captures), their replays and the graph pools' MiB. The
   deployment, the second insert, k63-deploy, k63-short and the trace
   each fail unless their flushes replayed a graph.
5. consolidate: the same 50 Mb inserted a second time (two finalize
   segments), lookups doubled, then consolidate() into one segment with
   the same distinct count and lookups; the kernel against its plain
   version at the consolidate's span shape.
   payload: the generic-payload index (data_api.BriskData, width 2,
   ("sum", "max"): count + last position) on the same 50 Mb at the
   counter's geometry: n_emitted and the count lane's total, the
   distinct count and 1,000 point lookups against the counter of phase
   4, every flush one graph replay (flush_graph.insert_payload);
   payload-graph: that graph against the eager program
   (pipeline.insert_windows_payload) on the deployment's first 6
   flushes, outputs and states bit for bit, the flush walls, one flush
   of each traced (host calls, device kernels, busy, idle), the
   captures, replays and pool; then BriskData on the card against the
   port on the CPU, bit for
   bit, at k=31 (width 3) and k=63 through insert_file (with repairs),
   update, reallocate and save -> load. This path launches the
   enumerator's kernels and no span expansion.
   sharded: the sharded facade (parallel.facade.ShardedBrisk, 8 shards
   on the one card) on the same 50 Mb at the counter's geometry (8 x 256
   lanes, window 512, stack 8): n_emitted and the shadow-free query_file
   total, the distinct count and 1,000 get_canonical calls against the
   counter of phase 4, every step one graph replay
   (flush_graph.insert_sharded), the kernel against its plain version at
   one shard's finalize span; sharded-graph: that graph against the
   eager program (sharded.sharded_insert_windows_sklonly) as
   payload-graph does; a forced spill (skl_route_cap 2) on 1 Mb whose
   counts_dict equals a Brisk's, then sharded-reload (a second insert +
   finalize, save -> ShardedBrisk.load on the card: every shard's runs
   rebuilt, the sampled get_canonical unchanged); then the facade on the
   card against the same facade on the CPU, every per-shard arena array,
   at k=31 (200 kb) and k=63 (30 kb), each with the repair fixture's
   record, through insert_file, finalize, reallocate and save -> load;
   the CPU half runs in a child process (`--sharded-cpu-reference`,
   started before the sharded phase and stopped with the smoke) beside
   the card's phases.
6. k63-deploy: k=63 m=21 b=14 on 4.6 Mb of 10 kb records (the streaming
   insert), then save/load, KFF export and read-back, query_file and
   reallocate; the kernel at the finalize's span shape.
7. k63-short: k=63 on 4.6 Mb of 150 bp reads through the short-read
   route.
8. counter-cli: `python -m brisk_tpu_torch.apps.counter --mode 2
   --device cuda -o <kff>` at k=31 and k=63.
9. trace: brisk_tpu_torch.trace_insert (torch.profiler) at the
   deployment's lanes and window, one batch per stack: the flush (the
   graph replay), the eager flush, finalize and query-join spans each
   launched kernels and have a device idle share strictly between 0 and
   1; each span's host launch calls are printed beside its kernels.
10. bench-quick: `python -m brisk_tpu_torch.bench --quick` in a child
   process on the card: exit 0, no `_error` field, its k-mer counts and
   query total equal to the oracle's (oracle.pyref, computed here
   meanwhile) on the same files, at least two mid-ingest segments in
   its scale stage.

Each main-path phase zeroes the kernel launch counters before it runs
and reads them after, and fails unless it launched every enumerator
kernel (the payload index builds no super-k-mer rows, so its phase
launches skl_rows none); the deployment's and the sharded query_file
and the k=63 query fail unless they launched join_scan, the k=63
reallocate unless it launched run_totals (each call's slots and device
time are printed); comparisons with the plain versions run outside those
windows.
The second-to-last line is the kernel report (JSON), the last line
`{"ok": true, "device": {...}}`. Needs one CUDA card; there is no CPU
fallback.
"""

import contextlib
import faulthandler
import json
import os
import random
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
K, M, B = 31, 11, 8
SYNTH_BASES, SYNTH_READ, SYNTH_SEED = 50_000_000, 10_000, 1234
EXPECT_KMERS = 49_695_519  # n_emitted and query_file total at k=31 m=11
K63 = (63, 21, 14)
K63_BASES = 4_600_000
EXPECT_K63_KMERS = 4_542_816        # 10 kb records (BENCH_r05 k63_nb_kmers)
EXPECT_K63_SHORT_KMERS = 2_681_840  # 150 bp reads (k63_shortread_nb_kmers)
# point lookups of the deployment (cut from 10,000: the batched lookups
# are host numpy, ~3.7 ms each, and the time went to the phases below)
N_LOOKUPS = 1_000
N_PAYLOAD_GETS = 1_000
# BriskData on the card against the CPU port: (k, m, b), bases, kinds,
# geometry
PAYLOAD_PARITY = (((K, M, B), 200_000, ("sum", "max", "min"),
                   dict(batch=64, window=64, stack=4)),
                  (K63, 30_000, ("sum", "max"),
                   dict(batch=64, window=256, stack=4)))
# ShardedBrisk: 8 shards on the one card at the counter's geometry (B =
# 8 x 256 = 2048 lanes); the forced-spill run; card against CPU
SHARDED_GEOMETRY = dict(n_devices=8, batch_per_shard=256, window=512,
                        stack=8)
N_SHARDED_GETS = 1_000
SPILL_BASES = 1_000_000
SPILL_GEOMETRY = dict(n_devices=8, batch_per_shard=64, window=512, stack=4)
N_RELOAD_GETS = 200
# trace_insert: the deployment's lanes and window, one batch per stack
TRACE_SIZE = dict(rec_bases=1_000_000, query_bases=250_000, batch=2048,
                  window=512, stack=1)
# launches of each traced span at TRACE_SIZE measured on the card when
# the enumerator ran as torch ops (the flush's per-position loop), printed
# beside this run's
LOOP_TRACE_LAUNCHES = {"flush": "10932", "flush_eager": "10932",
                       "finalize": "105-110", "query_join": "120-127"}
# the deployment's first flushes held graph against eager (more than
# Brisk._pending's depth of 4)
FLUSH_GRAPH_FLUSHES = 6
SHARDED_PARITY = (((K, M, B), 200_000,
                   dict(n_devices=8, batch_per_shard=8, window=64,
                        stack=4)),
                  (K63, 30_000, dict(n_devices=8, batch_per_shard=8,
                                     window=256, stack=4)))
# (k, m, b) and span sizes of phase 2's small and ragged spans; (63,61,1)
# gives s_max 5, the others 8
KERNEL_SPANS = (((K, M, B), (1000, 1001, 1024, 12288)),
                (K63, (1024, 12290)), ((63, 61, 1), (1027,)))
# the enumerator's kernels at ragged shapes, untimed: bench_enumerate
# geometry tuples (name, (k, m, b), B, L_out, windowed). state_scan takes
# lanes in groups of G (16 from B 2048, 8 from 1024, 4 from 512, 1 below
# 256) and positions in tiles of 32: one lane, lanes not a multiple of
# the group, L_out below a tile, one past it, and one position; the
# rescan's blocks of 256 positions and the position pipeline's tiles of
# 1,024 (runs of 8) cross rows; skl_rows takes a lane in tiles of 512
# (runs of 2): one tile cut short (203, 33 positions), one tile and one
# position, two tiles and more (walked forward, then backward)
ENUM_RAGGED = (("ragged-k31", (K, M, B), 33, 37, True),
               ("ragged-k63", K63, 1000, 203, False),
               ("one-position-k31", (K, M, B), 100, 1, False),
               ("one-lane-k31", (K, M, B), 1, 70, True),
               ("group-plus-two-k31", (K, M, B), 2050, 33, True),
               ("short-tile-k63", K63, 1031, 20, False),
               ("tile-plus-one-k63", K63, 40, 513, False),
               ("three-tiles-k31", (K, M, B), 64, 1100, True))
# the position pipeline and the rescan alone over rows
# (bench_enumerate.measure_rows: name, k_arg, m, R, L): fresh-lane inits
# (L = k - 1, rows shorter than a tile and than the k=63 window)
# and reallocate's rekey batch at m = 23 (bench_enumerate.REKEY_ROWS)
ENUM_ROWS = (("init-rows-k31", K - 1, M, 4096, K - 1),
             ("init-rows-k63", 62, 21, 4096, 62),
             ("rekey-k63-m23", 63, 23, 65536, 63))  # timed for positions
ENUM_KERNELS = ("positions", "rescan", "state_scan", "emit", "skl_rows")
# the run scan's kernels (csrc/run_scan.cu) and their ragged shapes,
# untimed: (name, kernel, slots, key words W, longest run): one slot, a
# group of 32 cut short, tiles of 256 to 2,048 slots cut short, runs
# longer than a tile (tiles in which no run starts); then shapes that
# stress the look-back: one run over 2^26 slots (no tile after the first
# starts a run) and run starts every ~100,000 slots
RUN_SCAN_KERNELS = ("join_scan", "run_totals")
RUN_SCAN_RAGGED = tuple(
    (f"{kind}-{kernel}-{n}-{W}-{max_run}", kernel, n, W, max_run)
    for kernel, W in (("join_scan", 3), ("join_scan", 6),
                      ("run_totals", 1))
    for kind, n, max_run in (
        ("ragged", 1, 3), ("ragged", 31, 3), ("ragged", 33, 40),
        ("ragged", 4097, 300), ("ragged", (1 << 17) + 1, 3),
        ("ragged", (1 << 20) + 3, 5000), ("ragged", (1 << 23) + 17, 9000),
        ("lookback", 1 << 26, 1 << 26),
        ("lookback", (1 << 26) + 5, 199_999)))
# calls of each run-scan shape, every one held to the plain version bit
# for bit (a look-back that read a status before its value would give a
# stale carry on some call)
RUN_SCAN_REPEATS = 5
# wall seconds the run scan's checks may take: past them the run fails
# with every thread's traceback (a look-back that never ends hangs in
# the synchronize)
RUN_SCAN_GUARD_S = 300


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reset_launches() -> None:
    from brisk_tpu_torch import kernels
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0


def kernel_launches() -> dict:
    """Launches since the last reset: of each span-expansion layout and of
    each enumerator kernel."""
    from brisk_tpu_torch import kernels
    n = {layout: launches(layout) for layout in ("jmajor", "rowmajor")}
    n.update({name: kernels.LAUNCHES[name]
              for name in ENUM_KERNELS + RUN_SCAN_KERNELS})
    return n


@contextlib.contextmanager
def scan_calls():
    """Each run-scan kernel call inside the block, as the yielded list of
    (kernel, slots, device ms): CUDA events on the current stream around
    the wrapper (read once the block has ended and synchronized)."""
    import torch
    from brisk_tpu_torch import kernels
    events, calls = [], []
    saved = {name: getattr(kernels, name) for name in RUN_SCAN_KERNELS}

    def timed(name):
        def call(*args):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = saved[name](*args)
            t1.record()
            events.append((name, args[0].shape[-1], t0, t1))
            return out
        return call

    for name in saved:
        setattr(kernels, name, timed(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)
        torch.cuda.synchronize()
        calls.extend((name, n, t0.elapsed_time(t1))
                     for name, n, t0, t1 in events)


def graph_replays() -> int:
    """Flush graph replays so far, over every cached graph."""
    from brisk_tpu_torch.index import flush_graph
    return sum(g["replays"] for g in flush_graph.graphs())


def check_enumerated(n: dict, phase: str, rows: bool = True) -> None:
    """The phase enumerated k-mers on the card through every enumerator
    kernel and, with `rows`, built super-k-mer rows through skl_rows."""
    names = ENUM_KERNELS if rows else ENUM_KERNELS[:-1]
    check(all(n[name] > 0 for name in names),
          f"{phase} did not launch every enumerator kernel: {n}")


def launches(layout: str = "") -> int:
    """Span-expansion launches since the last reset: of one layout, or of
    both."""
    from brisk_tpu_torch import kernels
    if layout:
        return kernels.LAUNCHES["expand_span_" + layout]
    return launches("jmajor") + launches("rowmajor")


def reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_gib(dev):
    import torch
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


@contextlib.contextmanager
def timed_state_machine(dev):
    """The per-position loop's share of insert: a synchronized host clock
    around every eager call of the enumerator's state machine, summed into
    the yielded dict's "s". A flush graph's replays run it without a
    call, and its capture cannot synchronize: neither is timed."""
    import torch
    from brisk_tpu_torch.ops import enumerate as enum_ops
    loop = {"s": 0.0}
    state_machine = enum_ops._state_machine

    def timed(*args):
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return state_machine(*args)
        sync(dev)
        t = time.perf_counter()
        out = state_machine(*args)
        sync(dev)
        loop["s"] += time.perf_counter() - t
        return out

    enum_ops._state_machine = timed
    try:
        yield loop
    finally:
        enum_ops._state_machine = state_machine


def repair_fixture(path: str) -> None:
    """One record mixing random sequence with a period-8 palindromic
    repeat and a poly-A run: its windows need exact repairs (equal-hash
    minimizer ties across window seams) and one lane overflows the
    per-lane row budget at batch=16, window=64."""
    random.seed(5)

    def rs(n):
        return "".join(random.choice("ACGT") for _ in range(n))

    rec = (rs(300) + "ACGTTGCA" * 200 + rs(300) + "AAAAAAAAAAAAC" * 80
           + rs(300))
    with open(path, "w") as fh:
        fh.write(">repair\n" + rec + "\n")


def kernel_vs_plain(sb, sm, sn, k: int, m: int, b: int, s_max: int,
                    timed: bool) -> dict:
    """The CUDA kernel in both layouts and its plain versions on the same
    span rows: bit-exact or raise; when `timed`, the CUDA-event times of
    each layout's kernel and of its own plain version (`jmajor_ms`,
    `jmajor_plain_ms`, `rowmajor_ms`, `rowmajor_plain_ms`)."""
    import torch
    from brisk_tpu_torch import bench_expand, kernels
    R = sb.shape[0]
    out = dict(R=R, max_abs_err=0)
    for layout in ("jmajor", "rowmajor"):
        got = kernels.expand_span(sb, sm, sn, k, m, b, s_max, layout=layout)
        want = bench_expand.plain(layout)(sb, sm, sn, k, m, b, s_max)
        torch.cuda.synchronize()
        err = int(((got.to(torch.int64) & 0xFFFFFFFF)
                   - (want.to(torch.int64) & 0xFFFFFFFF)).abs().max())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        check(torch.equal(got, want),
              f"{layout} kernel != plain at k={k} R={R}")
        del got, want
    if timed:
        args = (sb, sm, sn, k, m, b, s_max)
        for layout in ("jmajor", "rowmajor"):
            out[layout + "_ms"] = bench_expand.time_ms(
                lambda: kernels.expand_span(*args, layout=layout))
            out[layout + "_plain_ms"] = bench_expand.time_ms(
                lambda: bench_expand.plain(layout)(*args), calls=1)
        out["bound_ms"] = bench_expand.bound_ms(R, k, m, b)
    torch.cuda.empty_cache()
    return out


def arena_span(skl, R: int):
    """The first R rows of an arena as contiguous kernel inputs: the span
    a finalize or consolidate of rows [0, R) hands the kernel."""
    return (skl.bucket[:R].contiguous(), skl.meta[:R].contiguous(),
            skl.nucs[:, :R].contiguous())


def phase_kernels(dev) -> dict:
    """The span expansion in both layouts against its plain versions:
    small and ragged spans at three configurations, then the four span
    shapes of the main path (insert-shaped rows and rows with any meta),
    each timed by bench_expand.measure. Then the enumerator's five
    kernels (ENUM_KERNELS) against theirs: ragged shapes, then the
    insert's batch at the bench geometry and the k=63 streaming batch,
    timed by bench_enumerate.measure; the position pipeline and the
    rescan alone over ENUM_ROWS (the position pipeline timed at the rekey
    rows).
    Each enumerator kernel's worst difference is kept by name. Then the
    run scan's two kernels against theirs at RUN_SCAN_RAGGED and, timed,
    at bench_run_scan.SHAPES."""
    import torch
    from brisk_tpu_torch import bench_enumerate, bench_expand, bench_run_scan
    scan = {"max_abs_err": dict.fromkeys(RUN_SCAN_KERNELS, 0), "rows": []}
    faulthandler.dump_traceback_later(RUN_SCAN_GUARD_S, exit=True)
    try:
        for shape in RUN_SCAN_RAGGED + bench_run_scan.SHAPES:
            timed = shape in bench_run_scan.SHAPES
            r = bench_run_scan.measure(*shape, dev, timed=timed,
                                       repeats=RUN_SCAN_REPEATS)
            scan["max_abs_err"][r["kernel"]] = max(
                scan["max_abs_err"][r["kernel"]], r["max_abs_err"])
            say("kernel", **{key: v for key, v in r.items()
                             if key != "bytes"})
            if timed:
                scan["rows"].append(r)
    finally:
        faulthandler.cancel_dump_traceback_later()
    enum = {"max_abs_err": dict.fromkeys(ENUM_KERNELS, 0), "rows": []}
    errs = enum["max_abs_err"]
    for geo in ENUM_RAGGED + bench_enumerate.GEOMETRIES:
        timed = geo in bench_enumerate.GEOMETRIES
        for r in bench_enumerate.measure(*geo, dev, timed=timed):
            errs[r["kernel"]] = max(errs[r["kernel"]], r["max_abs_err"])
            say("kernel", **{key: v for key, v in r.items()
                             if key not in ("bytes", "fp64_adds")})
            if timed:
                enum["rows"].append(r)
        torch.cuda.empty_cache()
    for rows in ENUM_ROWS:
        timed = rows == bench_enumerate.REKEY_ROWS
        for r in bench_enumerate.measure_rows(*rows, dev, timed=timed):
            errs[r["kernel"]] = max(errs[r["kernel"]], r["max_abs_err"])
            say("kernel", **{key: v for key, v in r.items()
                             if key not in ("bytes", "fp64_adds")})
            if timed and r["kernel"] == "positions":
                enum["rows"].append(r)
        torch.cuda.empty_cache()
    worst = 0
    for (k, m, b), Rs in KERNEL_SPANS:
        for R in Rs:
            for garbage in (0.0, 0.05, 1.0):
                sb, sm, sn, s_max = bench_expand.span_rows(
                    R, k, m, b, seed=R + k, device=dev, garbage=garbage)
                res = kernel_vs_plain(sb, sm, sn, k, m, b, s_max, False)
                worst = max(worst, res["max_abs_err"])
            say("kernel", k=k, m=m, b=b, R=R, layouts="jmajor+rowmajor",
                exact=True, max_abs_err=res["max_abs_err"])
    shapes = []
    for name, (k, m, b), R, layout in bench_expand.SHAPES:
        for garbage in (0.0, 1.0):
            sb, sm, sn, s_max = bench_expand.span_rows(
                R, k, m, b, seed=R + k + 1, device=dev, garbage=garbage)
            res = kernel_vs_plain(sb, sm, sn, k, m, b, s_max, False)
            worst = max(worst, res["max_abs_err"])
            del sb, sm, sn
        say("kernel", shape=name, R=R, layouts="jmajor+rowmajor",
            meta="insert-shaped+any", exact=True)
        t = bench_expand.measure(name, (k, m, b), R, layout, dev)
        say("kernel-time", **{key: t[key] for key in (
            "shape", "layout", "R", "kernel_ms", "bound_ms",
            "share_of_bound", "fill_ms", "plain_ms")},
            old_path_ms=t.get("old_path_ms"))
        shapes.append(t)
    return dict(max_abs_err=worst, shapes=shapes, enum=enum, scan=scan)


def phase_fixtures(dev, tmp: str) -> None:
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.oracle import pyref
    from brisk_tpu_torch.params import Parameters
    rep = os.path.join(tmp, "repair.fa")
    repair_fixture(rep)
    for path in (os.path.join(REPO, "data", "test.fa"),
                 os.path.join(REPO, "data", "debug_test.fa"), rep):
        idx = Brisk(Parameters(K, M, B), batch=16, window=64, device=dev)
        idx.insert_file(path)
        got = idx.counts_dict()
        want = pyref.count_fasta(path, K, M)
        check(got == want, f"counts_dict != oracle on {path}")
        if path == rep:
            check(idx.n_repaired_windows > 0 and idx.n_skl_overflows > 0,
                  "repair fixture exercised no repair/overflow")
        say("fixture", file=os.path.basename(path), kmers=len(got),
            repaired_windows=idx.n_repaired_windows,
            repair_batches=idx.n_repair_batches,
            skl_overflows=idx.n_skl_overflows, parity=True)


def sample_kmers(path: str, n: int, seed: int = 7) -> list:
    """n k-mer strings at random positions of the input's ACGT chunks."""
    import numpy as np
    from brisk_tpu_torch import native
    from brisk_tpu_torch.oracle import pyref
    chunks = native.parse_fasta_codes(path)
    if chunks is None:
        chunks = [(np.frombuffer(c.encode(), np.uint8) >> 1) & 3
                  for c in pyref.read_fasta_chunks(path)]
    chunks = [c for c in chunks if len(c) >= K]
    letters = np.frombuffer(b"ACTG", np.uint8)  # code -> base
    rng = np.random.default_rng(seed)
    out = []
    for ci in rng.integers(0, len(chunks), n):
        c = chunks[int(ci)]
        p = int(rng.integers(0, len(c) - K + 1))
        out.append(letters[c[p:p + K]].tobytes().decode())
    return out


def canonical_counts(idx, sample: list) -> list:
    """Brisk.get_canonical over a sample, batched: each k-mer in its own
    orientation, the misses again as their reverse complements."""
    from brisk_tpu_torch.oracle import pyref
    got = idx.get_many(sample)
    miss = [i for i, c in enumerate(got) if c is None]
    rcs = [pyref.num2str(pyref.revcomp(pyref.str2num(sample[i]), K), K)
           for i in miss]
    for i, c in zip(miss, idx.get_many(rcs)):
        got[i] = c
    return got


def write_input(path: str, bases: int, read_len: int) -> None:
    from brisk_tpu_torch.io.synth import write_synth
    t = time.perf_counter()
    write_synth(path, bases, read_len=read_len, seed=SYNTH_SEED)
    say("input", file=os.path.basename(path), bases=bases,
        read_len=read_len, write_s=round(time.perf_counter() - t, 2))


def phase_deployment(dev, tmp: str) -> dict:
    import torch
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters

    path = os.path.join(tmp, "synth50m.fa")
    write_input(path, SYNTH_BASES, SYNTH_READ)

    idx = Brisk(Parameters(K, M, B), batch=2048, window=512, stack=8,
                device=dev)
    reset_peak(dev)
    reset_launches()
    replays0 = graph_replays()
    with timed_state_machine(dev) as loop:
        t0 = time.perf_counter()
        idx.warmup(path=path)
        sync(dev)
        t1 = time.perf_counter()
        idx.insert_file(path)
        idx._drain()
        sync(dev)
        t2 = time.perf_counter()
    loop_s = loop["s"]
    check(graph_replays() > replays0,
          "the deployment's flushes replayed no graph")
    launches_before = launches()
    idx.finalize()
    sync(dev)
    t3 = time.perf_counter()
    fin_launches = launches() - launches_before
    insert_s, finalize_s = t2 - t1, t3 - t2
    say("deploy-insert", warmup_s=round(t1 - t0, 3), insert_s=insert_s,
        finalize_s=finalize_s, parser=idx.parser,
        loop_s=loop_s, loop_share_of_insert=loop_s / insert_s,
        kmers_per_s=idx.n_emitted / (insert_s + finalize_s))
    check(idx.n_emitted == EXPECT_KMERS,
          f"n_emitted {idx.n_emitted} != {EXPECT_KMERS}")
    check(idx.n_repaired_windows == 0, "repairs on the synthetic input")
    check(idx.n_skl_overflows == 0, "skl overflows on the synthetic input")
    check(fin_launches > 0, "finalize did not launch the expansion kernel")
    for name in ("bucket", "meta", "nucs", "data", "offs"):
        check(getattr(idx.skl, name).device.type == dev.type,
              f"arena column {name} not on the card")

    # stats (distinct_count -> expand_device): the row-major kernel, no
    # J-major expansion and so no transpose of the key array
    jm0, rm0 = launches("jmajor"), launches("rowmajor")
    t = time.perf_counter()
    st = idx.stats()
    say("deploy-stats", stats_s=round(time.perf_counter() - t, 3),
        **{k: v for k, v in st.items()})
    check(launches("rowmajor") > rm0 and launches("jmajor") == jm0,
          "stats did not run the row-major kernel alone")

    # point lookups: N_LOOKUPS k-mers sampled from the input, both strands
    # (Brisk.get_canonical, batched)
    sample = sample_kmers(path, N_LOOKUPS)
    t = time.perf_counter()
    got = canonical_counts(idx, sample)
    get_s = time.perf_counter() - t
    for s, c in zip(sample[:20], got[:20]):
        check(idx.get_canonical(s) == c, "get_canonical != batched lookup")
    hits = sum(1 for c in got if c is not None and c >= 1)
    say("deploy-get", sampled=len(sample), found=hits, get_s=get_s)
    check(hits >= 0.95 * len(sample), f"only {hits} of {len(sample)} found")

    rm0 = launches("rowmajor")
    with scan_calls() as joins:
        t = time.perf_counter()
        total = idx.query_file(path)
        sync(dev)
        query_s = time.perf_counter() - t
    # the index side of the join expands row-major, the fresh query
    # shadow J-major; the join scans on the card
    check(launches("rowmajor") > rm0,
          "query_file's index side did not run the row-major kernel")
    check(any(name == "join_scan" for name, _, _ in joins),
          "query_file's join did not launch join_scan")
    say("deploy-query", query_s=query_s, total=total,
        total_mod32=total & 0xFFFFFFFF, kmers_per_s=EXPECT_KMERS / query_s,
        scan_calls=joins)
    check(total & 0xFFFFFFFF == EXPECT_KMERS,
          f"query_file total {total} != {EXPECT_KMERS}")
    n = kernel_launches()
    check(n["jmajor"] > 0 and n["rowmajor"] > 0,
          f"the main path did not launch both layouts: {n}")
    check_enumerated(n, "the deployment")
    say("deploy-memory", peak_gib=peak_gib(dev), launches=n)
    # orientation-sensitive counts for the payload phase's point lookups
    direct = idx.get_many(sample[:N_PAYLOAD_GETS])
    return dict(launches=n, idx=idx, path=path, sample=sample, got=got,
                direct=direct, nb_kmers=st["nb_kmers"], scan_calls=joins)


def phase_flush_graph(dev, dep: dict) -> dict:
    """The k=31 flush as Brisk runs it on the card (flush_graph.insert_flat,
    one graph replay a flush) against the eager program on the
    deployment's first FLUSH_GRAPH_FLUSHES flushes at its geometry, bit
    for bit; each path's flush wall; one flush of each traced; the cached
    graphs, replays and pools."""
    import torch
    from brisk_tpu_torch import trace_insert
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.index import flush_graph, pipeline, sklstore
    from brisk_tpu_torch.io import windows
    from brisk_tpu_torch.params import Parameters
    S, lanes = 8, 2048
    geo = Brisk(Parameters(K, M, B), batch=lanes, window=512, stack=S,
                device=dev)
    packer = windows.WindowPacker(K, M, lanes, l_out=geo.window)
    static = geo._flat_static(packer)
    stacks = []
    for fl in packer.pack_flat(geo._records(dep["path"]), S):
        stacks.append(tuple(torch.from_numpy(x).to(dev) for x in (
            fl.chunk4, fl.valid_start.reshape(S, lanes),
            fl.valid_end.reshape(S, lanes))))
        if len(stacks) == FLUSH_GRAPH_FLUSHES:
            break
    check(len(stacks) == FLUSH_GRAPH_FLUSHES,
          f"the deployment packed {len(stacks)} flushes")
    nw = sklstore.skl_dims(K, M, B)[3]
    rows = FLUSH_GRAPH_FLUSHES * S * lanes * geo.skl_row_cap
    arena = sklstore.empty(1 << rows.bit_length(), 1 << 14, nw, dev)
    del geo
    replays0 = graph_replays()
    runs, wall = {}, {}
    for name, fn in (("eager", pipeline.insert_flat_sklnative),
                     ("graph", flush_graph.insert_flat)):
        skl = sklstore.SklState(*(t.clone() for t in arena))
        chain = pipeline.zero_chain(dev)
        outs = []
        sync(dev)
        t = time.perf_counter()
        for st in stacks:
            out = fn(skl, *st, chain, *static)
            skl, chain = out[0], out[6]
            outs.append(out[1:])
        sync(dev)
        wall[name] = 1e3 * (time.perf_counter() - t) / len(stacks)
        runs[name] = (skl, outs)

    def same(a, c) -> bool:
        if isinstance(a, torch.Tensor):
            return a.dtype == c.dtype and torch.equal(a, c)
        return len(a) == len(c) and all(same(x, y) for x, y in zip(a, c))

    (e_skl, e_outs), (g_skl, g_outs) = runs["eager"], runs["graph"]
    for i, (e, g) in enumerate(zip(e_outs, g_outs)):
        check(same(e, g), f"flush {i}: the graph's outputs != the eager "
              "program's")
    check(same(tuple(e_skl), tuple(g_skl)),
          "the graph's arena != the eager program's")
    replays = graph_replays() - replays0
    check(replays == FLUSH_GRAPH_FLUSHES,
          f"{replays} graph replays for {FLUSH_GRAPH_FLUSHES} flushes")
    say("flush-graph", flushes=FLUSH_GRAPH_FLUSHES, equal=True,
        n_rows=int(g_skl.n_rows), eager_flush_ms=wall["eager"],
        graph_flush_ms=wall["graph"])
    del runs, e_skl, g_skl, e_outs, g_outs
    traced = {}
    for name, fn in (("flush", flush_graph.insert_flat),
                     ("flush_eager", pipeline.insert_flat_sklnative)):
        skl = sklstore.SklState(*(t.clone() for t in arena))
        _, traced[name] = trace_insert.traced_call(
            dev, name, lambda: int(fn(skl, *stacks[0],
                                      pipeline.zero_chain(dev),
                                      *static)[5]))
        check(traced[name]["launches"] > 0,
              f"the traced {name} ran no kernel")
    g, e = traced["flush"], traced["flush_eager"]
    say("flush-graph", host_launch_calls_per_flush=g["host_launch_calls"],
        eager=e["host_launch_calls"], graph_calls=g["host_calls"])
    say("flush-graph", device_kernels_per_flush=g["launches"],
        eager=e["launches"], busy_ms=g["busy_ms"], eager_busy_ms=e["busy_ms"],
        wall_ms=g["wall_ms"], eager_wall_ms=e["wall_ms"])
    graphs = flush_graph.graphs()
    say("flush-graph", captures=len(graphs),
        replays=sum(x["replays"] for x in graphs),
        captured_launches=[x["captured_launches"] for x in graphs])
    say("flush-graph", pool_mib=[round(x["pool_bytes"] / 2 ** 20, 1)
                                 for x in graphs],
        reserved_gib=torch.cuda.memory_reserved(dev) / 2 ** 30)
    return dict(graph=g, eager=e, wall=wall)


def phase_consolidate(dev, dep: dict) -> dict:
    """Two finalize segments of the same 50 Mb, then consolidate()."""
    idx, path, sample, single = (dep["idx"], dep["path"], dep["sample"],
                                 dep["got"])
    reset_peak(dev)
    reset_launches()
    replays0 = graph_replays()
    t = time.perf_counter()
    idx.insert_file(path)
    idx.finalize()
    sync(dev)
    insert2_s = time.perf_counter() - t
    check(graph_replays() > replays0,
          "the second insert's flushes replayed no graph")
    rows = int(idx.skl.n_rows)
    check(len(idx._skl_segments) == 2,
          f"{len(idx._skl_segments)} segments after the second insert")
    doubled = canonical_counts(idx, sample)
    want = [None if c is None else (2 * c) % 256 for c in single]
    check(doubled == want, "lookups after the second insert are not doubled")
    nb_before = idx.stats()["nb_kmers"]
    check(nb_before == dep["nb_kmers"], "second insert changed nb_kmers")
    jm0, rm0 = launches("jmajor"), launches("rowmajor")
    phase_peak = peak_gib(dev)
    reset_peak(dev)
    t = time.perf_counter()
    idx.consolidate()
    sync(dev)
    consolidate_s = time.perf_counter() - t
    consolidate_peak = peak_gib(dev)
    carry_launches = launches("rowmajor") - rm0
    check(carry_launches > 0, "consolidate did not launch the row-major "
          "kernel")
    check(launches("jmajor") == jm0,
          "consolidate ran the J-major kernel (and a transpose)")
    check(len(idx._skl_segments) == 1, "consolidate left several segments")
    check(int(idx.skl.n_rows) <= rows, "consolidate grew the arena")
    check(idx.stats()["nb_kmers"] == nb_before,
          "consolidate changed nb_kmers")
    check(canonical_counts(idx, sample) == want,
          "consolidate changed the lookups")
    n = kernel_launches()
    check_enumerated(n, "the second insert")
    say("consolidate", insert2_s=insert2_s, rows_before=rows,
        rows_after=int(idx.skl.n_rows), consolidate_s=consolidate_s,
        carry_launches=carry_launches, launches=n,
        peak_gib=phase_peak and max(phase_peak, peak_gib(dev)),
        consolidate_peak_gib=consolidate_peak)
    # the kernel at the consolidate's span shape, on the arena's rows
    from brisk_tpu_torch.index import sklstore
    R = sklstore._shape_family(rows, floor=1 << 10)
    s_max = sklstore.skl_dims(K, M, B)[1]
    res = kernel_vs_plain(*arena_span(idx.skl, R), K, M, B, s_max,
                          timed=True)
    say("kernel", at="consolidate", k=K, R=R, exact=True,
        **{key: v for key, v in res.items() if key != "R"})
    return dict(launches=n, kernel=res)


def phase_payload(dev, dep: dict) -> dict:
    """BriskData (count, last position) on the deployment's 50 Mb at the
    counter's geometry, held to the counter of phase 4."""
    import torch
    from brisk_tpu_torch._u32 import to_u32
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.index import payload
    from brisk_tpu_torch.params import Parameters
    bd = BriskData(Parameters(K, M, B), width=2, kinds=("sum", "max"),
                   batch=2048, window=512, stack=8, device=dev)
    comp = {"n": 0, "s": 0.0}
    compact = payload.compact

    def timed_compact(state, kinds):
        sync(dev)
        t = time.perf_counter()
        out = compact(state, kinds)
        sync(dev)
        comp["n"] += 1
        comp["s"] += time.perf_counter() - t
        return out

    flushes = [0]
    flush = bd._flush

    def counted_flush(*args):
        flushes[0] += 1
        return flush(*args)

    bd._flush = counted_flush
    reset_peak(dev)
    reset_launches()
    replays0 = program_replays("payload")
    payload.compact = timed_compact
    try:
        t = time.perf_counter()
        bd.insert_file(dep["path"])
        sync(dev)
        insert_s = time.perf_counter() - t
        n_insert_compactions, insert_compact_s = comp["n"], comp["s"]
        bd.compact()
    finally:
        payload.compact = compact
    st = bd.state
    n = st.n_sorted
    lane0 = int(to_u32(st.data[0, :n]).sum())
    replays = program_replays("payload") - replays0
    say("payload-insert", insert_s=insert_s, flushes=flushes[0],
        graph_replays=replays,
        compactions_in_insert=n_insert_compactions,
        insert_compact_s=insert_compact_s, compactions=comp["n"],
        compact_s=comp["s"], final_compact_s=comp["s"] - insert_compact_s,
        n_emitted=bd.n_emitted, lane0_total=lane0, n_sorted=n,
        n_repaired_windows=bd.n_repaired_windows,
        capacity=st.keys.shape[1],
        bytes_per_entry=(bd.W + bd.width) * 4 * st.keys.shape[1] / n,
        peak_gib=peak_gib(dev), launches=kernel_launches())
    check(replays == flushes[0] > 0,
          f"{replays} payload graph replays for {flushes[0]} flushes")
    check(bd.n_emitted == EXPECT_KMERS,
          f"payload n_emitted {bd.n_emitted} != {EXPECT_KMERS}")
    check(lane0 == EXPECT_KMERS, f"payload lane-0 total {lane0}")
    check(n == dep["nb_kmers"],
          f"payload n_sorted {n} != counter nb_kmers {dep['nb_kmers']}")
    check(st.keys.device.type == dev.type, "payload state not on the card")
    check(launches() == 0, "the payload path launched the span expansion")
    n = kernel_launches()
    check_enumerated(n, "the payload insert", rows=False)
    sample = dep["sample"][:N_PAYLOAD_GETS]
    t = time.perf_counter()
    got = [bd.get(s) for s in sample]
    get_s = time.perf_counter() - t
    for s, g, c in zip(sample, got, dep["direct"]):
        check((g is None) == (c is None)
              and (g is None or g[0] % 256 == c),
              f"payload get({s}) = {g}, counter {c}")
    say("payload-get", sampled=len(sample),
        found=sum(g is not None for g in got), get_s=get_s,
        agrees_with_counter=True)
    del bd, st
    torch.cuda.empty_cache()
    return dict(launches=n)


def program_replays(program: str) -> int:
    """Replays so far of the flush graphs of one program."""
    from brisk_tpu_torch.index import flush_graph
    return sum(g["replays"] for g in flush_graph.graphs()
               if g["program"] == program)


def phase_insert_graph(dev, dep: dict, which: str) -> dict:
    """The payload insert (which="payload", as BriskData runs it) or the
    sharded step ("sharded", as ShardedBrisk runs it on 8 shards of the
    card) through its graph runner (flush_graph.insert_payload /
    insert_sharded, one replay a flush) against its eager program on the
    deployment's first FLUSH_GRAPH_FLUSHES flushes at its geometry: every
    flush's outputs held to the end and the states whole, bit for bit;
    each path's flush wall (the first flush apart); one flush of each
    traced (trace_insert.traced_call: host calls, device kernels, busy,
    idle); the program's captures, replays and pool."""
    import torch
    from brisk_tpu_torch import trace_insert
    from brisk_tpu_torch.index import flush_graph, pipeline
    graph_span, eager_span = (trace_insert.INSERT_SPANS[:2]
                              if which == "payload"
                              else trace_insert.INSERT_SPANS[2:])
    programs = trace_insert.insert_programs(dev, dep["path"],
                                            FLUSH_GRAPH_FLUSHES, which)
    replays0 = program_replays(which)
    runs, wall = {}, {}
    for span in (eager_span, graph_span):
        fn, (_, at), fresh = programs[span]
        st, ch, outs, ms = fresh(), pipeline.zero_chain(dev), [], []
        for i in range(FLUSH_GRAPH_FLUSHES):
            sync(dev)
            t = time.perf_counter()
            out = fn(st, i, ch)
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t))
            st, ch = out[0], out[at]
            outs.append(out[1:])
        wall[span] = dict(first_ms=ms[0], ms=sum(ms[1:]) / len(ms[1:]))
        runs[span] = (st, outs)

    def same(a, c) -> bool:
        if isinstance(a, torch.Tensor):
            return a.dtype == c.dtype and torch.equal(a, c)
        if isinstance(a, (tuple, list)):
            return len(a) == len(c) and all(same(x, y)
                                            for x, y in zip(a, c))
        return a == c

    (e_st, e_outs), (g_st, g_outs) = runs[eager_span], runs[graph_span]
    for i, (e, g) in enumerate(zip(e_outs, g_outs)):
        check(same(e, g), f"{which} flush {i}: the graph's outputs != the "
              "eager program's")
    check(same(tuple(e_st), tuple(g_st)),
          f"the {which} graph's state != the eager program's")
    replays = program_replays(which) - replays0
    check(replays == FLUSH_GRAPH_FLUSHES,
          f"{replays} {which} graph replays for {FLUSH_GRAPH_FLUSHES} "
          "flushes")
    phase = f"{which}-graph"
    say(phase, flushes=FLUSH_GRAPH_FLUSHES, equal=True,
        n_km=[int(o[0 if which == "payload" else 1]) for o in g_outs],
        eager_first_flush_ms=wall[eager_span]["first_ms"],
        eager_flush_ms=wall[eager_span]["ms"],
        graph_first_flush_ms=wall[graph_span]["first_ms"],
        graph_flush_ms=wall[graph_span]["ms"])
    del runs, e_st, g_st, e_outs, g_outs
    traced = {}
    for span in (graph_span, eager_span):
        fn, (km_at, _), fresh = programs[span]
        _, traced[span] = trace_insert.traced_call(
            dev, span, lambda: int(fn(fresh(), 0,
                                      pipeline.zero_chain(dev))[km_at]))
        check(traced[span]["launches"] > 0,
              f"the traced {span} ran no kernel")
    g, e = traced[graph_span], traced[eager_span]
    say(phase, host_launch_calls_per_flush=g["host_launch_calls"],
        eager=e["host_launch_calls"], graph_calls=g["host_calls"])
    say(phase, device_kernels_per_flush=g["launches"], eager=e["launches"],
        busy_ms=g["busy_ms"], eager_busy_ms=e["busy_ms"],
        wall_ms=g["wall_ms"], eager_wall_ms=e["wall_ms"],
        idle=g["device_idle_share"], eager_idle=e["device_idle_share"])
    graphs = [x for x in flush_graph.graphs() if x["program"] == which]
    say(phase, captures=len(graphs),
        replays=sum(x["replays"] for x in graphs),
        captured_launches=[x["captured_launches"] for x in graphs],
        capture_s=[x["capture_s"] for x in graphs],
        pool_mib=[round(x["pool_bytes"] / 2 ** 20, 1) for x in graphs],
        reserved_gib=torch.cuda.memory_reserved(dev) / 2 ** 30)
    del programs
    torch.cuda.empty_cache()
    return dict(graph=g, eager=e, wall=wall)


def phase_payload_parity(dev, tmp: str) -> None:
    """BriskData on the card against the port on the CPU, arrays equal
    after insert_file (a file that needs repairs), update, reallocate
    and save -> load."""
    import numpy as np
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.index import payload
    from brisk_tpu_torch.oracle import pyref
    from brisk_tpu_torch.io.synth import write_synth
    from brisk_tpu_torch.params import Parameters
    rep = os.path.join(tmp, "repair_rec.fa")
    repair_fixture(rep)
    with open(rep) as fh:
        repair_rec = fh.read()
    for (k, m, b), bases, kinds, geo in PAYLOAD_PARITY:
        path = os.path.join(tmp, f"payload_k{k}.fa")
        write_synth(path, bases, read_len=SYNTH_READ, seed=SYNTH_SEED + k)
        with open(path, "a") as fh:
            fh.write(repair_rec)
        built = [BriskData(Parameters(k, m, b), width=len(kinds),
                           kinds=kinds, device=d, **geo)
                 for d in ("cpu", dev)]
        times = {}

        def same(step):
            a, c = (payload.to_numpy(bd.state) for bd in built)
            for f in ("keys", "data", "n_sorted", "n_used"):
                check(np.array_equal(a[f], c[f]),
                      f"payload k={k} {step}: {f} differs card vs CPU")
            check(built[0].n_emitted == built[1].n_emitted
                  and built[0].n_repaired_windows
                  == built[1].n_repaired_windows,
                  f"payload k={k} {step}: counters differ card vs CPU")

        def run(step, fn):
            for bd, d in zip(built, ("cpu", "card")):
                t = time.perf_counter()
                fn(bd)
                sync(bd.device)
                times[f"{step}_{d}_s"] = round(time.perf_counter() - t, 3)
            same(step)

        run("insert", lambda bd: bd.insert_file(path))
        n_repaired = built[1].n_repaired_windows
        check(n_repaired > 0, f"payload k={k}: no window repaired")
        entries = list(built[0].items())  # items() compacts both
        check(list(built[1].items()) == entries,
              f"payload k={k}: items() differ card vs CPU")
        same("compact")
        kmers = [pyref.num2str(v, k) for v, _ in entries[::997]]
        kmers.append("ACGT" * (k // 4) + "ACG"[:k % 4])
        vals = np.array([[3] * len(kmers)] + [list(range(len(kmers)))]
                        * (len(kinds) - 1), np.uint32)
        run("update", lambda bd: bd.update(kmers, vals))
        check([built[1].get(s) for s in kmers]
              == [built[0].get(s) for s in kmers],
              f"payload k={k}: get differs card vs CPU")
        run("reallocate", lambda bd: bd.reallocate())
        for i, d in enumerate(("cpu", dev)):
            ckpt = os.path.join(tmp, f"payload_k{k}_{i}.npz")
            built[i].save(ckpt)
            built[i] = BriskData.load(ckpt, device=d)
        check(built[1].state.keys.device.type == dev.type,
              "payload load left the card")
        same("save-load")
        say("payload-parity", k=k, m=m, b=b, kinds="+".join(kinds),
            bases=bases, entries=len(entries),
            n_emitted=built[1].n_emitted,
            n_repaired_windows=n_repaired,
            steps="insert+update+reallocate+save-load", bit_exact=True,
            **times)


def phase_sharded(dev, dep: dict) -> dict:
    """ShardedBrisk, 8 shards on the one card, on the deployment's 50 Mb
    at the counter's geometry (batch 8 x 256 = 2048, window 512, stack
    8), held to the counter of phase 4; the kernel against its plain
    version at one shard's finalize span."""
    import torch
    from brisk_tpu_torch.index import sklstore
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    sb = ShardedBrisk(Parameters(K, M, B), device=dev, **SHARDED_GEOMETRY)
    flushes = [0]
    flush = sb._flush_stack

    def counted_flush(*args):
        flushes[0] += 1
        return flush(*args)

    sb._flush_stack = counted_flush
    reset_peak(dev)
    reset_launches()
    replays0 = program_replays("sharded")
    t0 = time.perf_counter()
    sb.insert_file(dep["path"])
    sync(dev)
    t1 = time.perf_counter()
    replays = program_replays("sharded") - replays0
    sb.finalize()
    sync(dev)
    t2 = time.perf_counter()
    fin = kernel_launches()
    rows = [int(x) for x in sb.skl.n_rows]
    say("sharded-insert", n_shards=sb.n_shards, insert_s=t1 - t0,
        flushes=flushes[0], graph_replays=replays,
        finalize_s=t2 - t1, n_emitted=sb.n_emitted, n_spilled=sb.n_spilled,
        n_repaired_windows=sb.n_repaired_windows,
        n_skl_overflows=sb.n_skl_overflows, rows_per_shard=rows,
        rcap=sb.skl.bucket.shape[1], route_cap=sb.skl_route_cap,
        kmers_per_s=sb.n_emitted / (t2 - t0), finalize_launches=fin)
    check(replays == flushes[0] > 0,
          f"{replays} sharded graph replays for {flushes[0]} flushes")
    check(sb.n_emitted == EXPECT_KMERS,
          f"sharded n_emitted {sb.n_emitted} != {EXPECT_KMERS}")
    check(fin["jmajor"] >= sb.n_shards,
          "sharded finalize did not launch the kernel on every shard")
    check(sb.skl.bucket.device.type == dev.type, "arenas not on the card")
    t = time.perf_counter()
    st = sb.stats()
    stats_s = time.perf_counter() - t
    check(st["nb_kmers"] == dep["nb_kmers"],
          f"sharded nb_kmers {st['nb_kmers']} != counter {dep['nb_kmers']}")
    rm0 = launches("rowmajor")
    joins = {"s": 0.0}
    join = sklstore.query_join_keys_total

    def timed_join(*args, **kw):
        sync(dev)
        t = time.perf_counter()
        out = join(*args, **kw)
        sync(dev)
        joins["s"] += time.perf_counter() - t
        return out

    sklstore.query_join_keys_total = timed_join
    try:
        with scan_calls() as scans:
            t = time.perf_counter()
            total = sb.query_file(dep["path"])
            sync(dev)
            query_s = time.perf_counter() - t
    finally:
        sklstore.query_join_keys_total = join
    check(launches("rowmajor") - rm0 >= sb.n_shards,
          "the sharded query did not expand every shard on the card")
    check(sum(name == "join_scan" for name, _, _ in scans) >= sb.n_shards,
          "the sharded query did not launch join_scan on every shard")
    check(total == EXPECT_KMERS,
          f"sharded query_file total {total} != {EXPECT_KMERS}")
    sample = dep["sample"][:N_SHARDED_GETS]
    rm0 = launches("rowmajor")
    t = time.perf_counter()
    got = [sb.get_canonical(s) for s in sample]
    get_s = time.perf_counter() - t
    check(got == dep["got"][:N_SHARDED_GETS],
          "sharded get_canonical != the counter's counts")
    check(launches("rowmajor") > rm0, "the probes launched no kernel")
    n = kernel_launches()
    check_enumerated(n, "the sharded insert and query")
    say("sharded-read", stats_s=stats_s, nb_kmers=st["nb_kmers"],
        index_bytes=st["index_bytes"], bytes_per_kmer=st["bytes_per_kmer"],
        query_s=query_s, query_join_s=joins["s"], query_total=total,
        scan_calls=scans, gets=len(sample), get_s=get_s,
        found=sum(c is not None for c in got), peak_gib=peak_gib(dev),
        launches=n)
    # the kernel at the span one shard's finalize handed it
    s_max = sklstore.skl_dims(K, M, B)[1]
    R = sklstore._shape_family(rows[0], floor=1 << 10)
    span = (sb.skl.bucket[0, :R].contiguous(),
            sb.skl.meta[0, :R].contiguous(),
            sb.skl.nucs[0, :, :R].contiguous())
    del sb
    torch.cuda.empty_cache()
    res = kernel_vs_plain(*span, K, M, B, s_max, timed=True)
    say("kernel", at="sharded-finalize", k=K, R=R, exact=True,
        **{key: v for key, v in res.items() if key != "R"})
    return dict(launches=n, kernel=res, scan_calls=scans)


def phase_sharded_spill(dev, tmp: str) -> None:
    """A forced spill (skl_route_cap 2) on ~1 Mb: rows past two per
    destination stay on their source shard; counts_dict equals a port
    Brisk's on the same file. Then sharded-reload: a second insert +
    finalize cycle (two bucket-sorted runs per shard), save and
    ShardedBrisk.load on the card, which rebuilds every shard's runs from
    its bucket column; each sampled get_canonical equals its value
    before save and the Brisk's count doubled."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    path = os.path.join(tmp, "spill.fa")
    write_input(path, SPILL_BASES, SYNTH_READ)
    sb = ShardedBrisk(Parameters(K, M, B), device=dev, skl_route_cap=2,
                      **SPILL_GEOMETRY)
    t = time.perf_counter()
    sb.insert_file(path)
    sync(dev)
    insert_s = time.perf_counter() - t
    got = sb.counts_dict()
    ref = Brisk(Parameters(K, M, B), batch=512, window=512, stack=4,
                device=dev)
    ref.insert_file(path)
    check(sb.n_spilled > 0, "skl_route_cap=2 spilled nothing")
    check(got == ref.counts_dict(), "spilled counts_dict != Brisk's")
    check(sb.n_emitted == ref.n_emitted, "spilled n_emitted != Brisk's")
    say("sharded-spill", bases=SPILL_BASES, n_spilled=sb.n_spilled,
        n_emitted=sb.n_emitted, kmers=len(got), insert_s=insert_s,
        exact=True)

    sb.insert_file(path)
    sb.finalize()
    runs = [len(sb._skl_segments[d]) for d in range(sb.n_shards)]
    check(min(runs) >= 2, f"two finalize cycles left runs {runs}")
    sample = sample_kmers(path, N_RELOAD_GETS, seed=11)
    want = [None if c is None else (2 * c) % 256
            for c in canonical_counts(ref, sample)]
    before = [sb.get_canonical(s) for s in sample]
    check(before == want, "sharded gets after two cycles != 2 x Brisk's")
    ckpt = os.path.join(tmp, "sharded_reload.npz")
    t = time.perf_counter()
    sb.save(ckpt)
    back = ShardedBrisk.load(ckpt, device=dev, skl_route_cap=2,
                             **SPILL_GEOMETRY)
    sync(dev)
    reload_s = time.perf_counter() - t
    check(back.skl.bucket.device.type == dev.type, "reload left the card")
    rebuilt = [len(back._skl_segments[d]) for d in range(back.n_shards)]
    check(min(rebuilt) >= 2, f"reload rebuilt runs {rebuilt}")
    t = time.perf_counter()
    after = [back.get_canonical(s) for s in sample]
    get_s = time.perf_counter() - t
    check(after == before, "sharded get_canonical changed across save -> "
          "load")
    say("sharded-reload", cycles=2, runs_per_shard=runs,
        rebuilt_runs_per_shard=rebuilt, gets=len(sample),
        found=sum(c is not None for c in after), save_load_s=reload_s,
        get_s=get_s, exact=True)


PARITY_STEPS = ("insert", "finalize", "reallocate", "save-load")
PARITY_COUNTERS = ("n_emitted", "n_superkmers", "n_spilled",
                   "n_repaired_windows", "n_skl_overflows")


def sharded_parity_inputs(tmp: str) -> dict:
    """k -> FASTA of SHARDED_PARITY: synthetic records, then the repair
    fixture's record."""
    from brisk_tpu_torch.io.synth import write_synth
    rep = os.path.join(tmp, "repair_rec.fa")
    repair_fixture(rep)
    with open(rep) as fh:
        repair_rec = fh.read()
    paths = {}
    for (k, _, _), bases, _ in SHARDED_PARITY:
        paths[k] = os.path.join(tmp, f"sharded_k{k}.fa")
        write_synth(paths[k], bases, read_len=SYNTH_READ,
                    seed=SYNTH_SEED + k)
        with open(paths[k], "a") as fh:
            fh.write(repair_rec)
    return paths


def sharded_parity_run(device, tmp: str, kmb, geo, path: str):
    """ShardedBrisk on `device` through PARITY_STEPS; yields (step,
    snapshot, seconds), a snapshot being every shard-axis arena array
    (numpy) and the host counters."""
    import torch
    from brisk_tpu_torch import _u32
    from brisk_tpu_torch.index import sklstore
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    dev = torch.device(device)
    sb = ShardedBrisk(Parameters(*kmb), device=dev, **geo)
    ckpt = os.path.join(tmp, f"sharded_k{kmb[0]}_{dev.type}.npz")
    for step in PARITY_STEPS:
        t = time.perf_counter()
        if step == "insert":
            sb.insert_file(path)
        elif step == "finalize":
            sb.finalize()
        elif step == "reallocate":
            sb.reallocate()
        else:
            sb.save(ckpt)
            sb = ShardedBrisk.load(ckpt, device=dev, **geo)
        sync(dev)
        seconds = time.perf_counter() - t
        check(sb.skl.bucket.device.type == dev.type,
              f"sharded {step} left {dev.type}")
        # copies: the next step writes the arena in place
        snap = {name: (_u32.to_np(x) if x.dtype.itemsize == 4
                       else x.cpu().numpy()).copy()
                for name, x in zip(sklstore.SklState._fields, sb.skl)}
        snap.update({c: getattr(sb, c) for c in PARITY_COUNTERS})
        yield step, snap, seconds


def sharded_cpu_reference(tmp: str) -> None:
    """The CPU half of phase_sharded_parity, run as a child process so it
    overlaps the card's sharded phases: every step's snapshot to
    `{tmp}/sharded_ref_k{k}_{step}.npz`."""
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    torch.set_num_threads(4)
    for (k, m, b), _, geo in SHARDED_PARITY:
        path = os.path.join(tmp, f"sharded_k{k}.fa")
        for step, snap, seconds in sharded_parity_run(
                "cpu", tmp, (k, m, b), geo, path):
            np.savez(os.path.join(tmp, f"sharded_ref_k{k}_{step}.npz"),
                     seconds=seconds, **snap)


def start_sharded_reference(tmp: str) -> subprocess.Popen:
    """Write the parity inputs and start sharded_cpu_reference."""
    sharded_parity_inputs(tmp)
    with open(os.path.join(tmp, "sharded_ref.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--sharded-cpu-reference", tmp], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=REPO))


def phase_sharded_parity(dev, tmp: str, ref: subprocess.Popen) -> None:
    """ShardedBrisk on the card against the same facade on the CPU (the
    child process `ref`), every per-shard arena array and counter equal
    after insert_file (a file that needs repairs), finalize, reallocate
    and save -> load."""
    import numpy as np
    card = {}
    for (k, m, b), bases, geo in SHARDED_PARITY:
        path = os.path.join(tmp, f"sharded_k{k}.fa")
        card[k] = list(sharded_parity_run(dev, tmp, (k, m, b), geo, path))
    t = time.perf_counter()
    rc = ref.wait(timeout=900)
    wait_s = time.perf_counter() - t
    with open(os.path.join(tmp, "sharded_ref.log")) as fh:
        check(rc == 0, f"the CPU reference exited {rc}:\n{fh.read()[-3000:]}")
    for (k, m, b), bases, geo in SHARDED_PARITY:
        times = {}
        for step, got, seconds in card[k]:
            want = np.load(os.path.join(tmp, f"sharded_ref_k{k}_{step}.npz"))
            for name, x in got.items():
                check(np.array_equal(np.asarray(x), want[name]),
                      f"sharded k={k} {step}: {name} differs card vs CPU")
            times[f"{step}_cpu_s"] = round(float(want["seconds"]), 3)
            times[f"{step}_card_s"] = round(seconds, 3)
        snap = card[k][0][1]
        check(snap["n_repaired_windows"] > 0,
              f"sharded k={k}: no window repaired")
        say("sharded-parity", k=k, m=m, b=b, bases=bases,
            n_emitted=snap["n_emitted"],
            n_repaired_windows=snap["n_repaired_windows"],
            n_spilled=snap["n_spilled"], steps="+".join(PARITY_STEPS),
            bit_exact=True, cpu_wait_s=round(wait_s, 3), **times)


def start_bench_quick(tmp: str) -> tuple:
    """Write the quick bench's inputs (io.synth, the bench's file names)
    and start `python -m brisk_tpu_torch.bench --quick` on the card in a
    child process; returns (process, data directory, log path)."""
    from brisk_tpu_torch import bench
    data = os.path.join(tmp, "bench_data")
    for stage, read_len in (("e2e", SYNTH_READ), ("k63", SYNTH_READ),
                            ("k63_short", 150), ("scale500", SYNTH_READ)):
        bench.synth_path(data, bench.QUICK[stage]["n_bases"], read_len)
    log = os.path.join(tmp, "bench_quick.out")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "brisk_tpu_torch.bench", "--quick",
             "--data-dir", data], cwd=REPO, stdout=out,
            stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=REPO))
    return proc, data, log


def phase_bench_quick(started: tuple) -> None:
    """The quick bench (every stage on the card at ~1/50 of its size)
    exits 0 with no `_error` field; its k-mer counts and query total equal
    the oracle's (oracle.pyref, computed here while the bench runs) on
    the same files; its 10 Mb scale stage finalized at least twice
    mid-ingest."""
    from brisk_tpu_torch import bench
    from brisk_tpu_torch.oracle import pyref
    proc, data, log = started
    try:
        e2e = bench.synth_path(data, bench.QUICK["e2e"]["n_bases"])
        counts = pyref.count_fasta(e2e, K, M)
        want = dict(
            e2e_nb_kmers=sum(counts.values()),
            query_file_total_mod256=sum(c * c for c in counts.values())
            & 0xFFFFFFFF)
        for key, read_len in (("k63_nb_kmers", SYNTH_READ),
                              ("k63_shortread_nb_kmers", 150)):
            path = bench.synth_path(data, bench.QUICK["k63"]["n_bases"],
                                    read_len)
            want[key] = sum(len(c) - K63[0] + 1
                            for c in pyref.read_fasta_chunks(path)
                            if len(c) >= K63[0])
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log) as fh:
        text = fh.read()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    check(rc == 0 and lines, f"bench --quick exited {rc}:\n{text[-3000:]}")
    rec = json.loads(lines[-1])
    errors = {key: v for key, v in rec.items() if key.endswith("_error")}
    check(not errors, f"bench --quick stage errors: {errors}")
    for key, value in want.items():
        check(rec[key] == value, f"bench --quick {key} {rec[key]} != "
              f"oracle {value}")
    check(rec["e2e_repaired_windows"] == 0 and rec["e2e_skl_overflows"] == 0,
          "bench --quick repaired or overflowed")
    check(rec["scale500_segments"] >= 2,
          f"scale stage gave {rec['scale500_segments']} segments")
    check(rec["sharded_n_spilled_n8"] == 0
          and rec["sharded_nb_kmers_n1"] == rec["sharded_nb_kmers_n8"],
          "sharded stage: spills or unequal totals")
    say("bench-quick", rc=rc, oracle_equal=sorted(want),
        **{key: rec[key] for key in (
            "value", "e2e_warm_kmers_per_sec", "stage_insert_s",
            "stage_query_s", "expand_kernel_ms", "expand_share_of_bound",
            "k63_insert_s", "scale500_segments", "scale500_insert_s",
            "scale500_peak_gib", "sharded_step_ms_n1", "sharded_step_ms_n8")})


def phase_trace(dev, tmp: str) -> dict:
    """trace_insert at the deployment's batch and window, one batch per
    stack (a quarter of the launches of the bench's 8): the flush,
    finalize and query-join spans are each present, launched kernels and
    were neither idle throughout nor never idle."""
    from brisk_tpu_torch import trace_insert
    reset_launches()
    replays0 = graph_replays()
    rows = trace_insert.trace(dev, os.path.join(tmp, "trace"), **TRACE_SIZE)
    check(graph_replays() > replays0, "the traced flush replayed no graph")
    n = kernel_launches()
    check([r["span"] for r in rows] == list(trace_insert.SPANS),
          f"trace spans {[r['span'] for r in rows]}")
    for r in rows:
        check(r["launches"] > 0 and 0 < r["device_idle_share"] < 1,
              f"trace span {r['span']}: launches {r['launches']}, idle "
              f"{r['device_idle_share']}")
        say("trace", span=r["span"], wall_ms=r["wall_ms"],
            untraced_wall_ms=r["untraced_wall_ms"], launches=r["launches"],
            host_launch_calls=r["host_launch_calls"],
            busy_ms=r["busy_ms"], device_idle_share=r["device_idle_share"],
            launches_as_torch_ops=LOOP_TRACE_LAUNCHES[r["span"]],
            outside_span=r["outside_span"], attempts=r["attempts"],
            top_kernel=r["top_kernels"][0]["name"][:60],
            hand_kernels=r["hand_kernels"])
    check(n["jmajor"] > 0 and n["rowmajor"] > 0,
          f"the traced finalize and join did not launch both layouts: {n}")
    join = rows[list(trace_insert.SPANS).index("query_join")]
    check("join_scan" in join["hand_kernels"],
          "the traced query join ran no join_scan kernel")
    check_enumerated(n, "the traced flush")
    return dict(launches=n)


def phase_k63_deploy(dev, tmp: str) -> dict:
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.index import sklstore
    from brisk_tpu_torch.io import kff
    from brisk_tpu_torch.params import Parameters
    k, m, b = K63
    path = os.path.join(tmp, "synth_k63.fa")
    write_input(path, K63_BASES, SYNTH_READ)
    idx = Brisk(Parameters(k, m, b), batch=1024, window=512, stack=4,
                device=dev)
    reset_peak(dev)
    reset_launches()
    replays0 = graph_replays()
    with timed_state_machine(dev) as loop:
        t0 = time.perf_counter()
        idx.warmup(os.path.getsize(path), record_len_hint=SYNTH_READ,
                   path=path)
        sync(dev)
        t1 = time.perf_counter()
        idx.insert_file(path)
        idx._drain()
        sync(dev)
        t2 = time.perf_counter()
    rows = int(idx.skl.n_rows)
    check(graph_replays() > replays0,
          "the k=63 deployment's flushes replayed no graph")
    n0 = launches()
    idx.finalize()
    sync(dev)
    t3 = time.perf_counter()
    fin_launches = launches() - n0
    # the span the finalize handed the kernel: rows [0, R) bucket-sorted
    # in place (dead rows INVALID)
    R = sklstore._shape_family(rows, floor=1 << 10)
    span = arena_span(idx.skl, R)
    insert_s, finalize_s = t2 - t1, t3 - t2
    say("k63-insert", warmup_s=round(t1 - t0, 3), insert_s=insert_s,
        finalize_s=finalize_s, n_emitted=idx.n_emitted, rows=rows,
        loop_share_of_insert=loop["s"] / insert_s,
        kmers_per_s=idx.n_emitted / (insert_s + finalize_s),
        peak_gib=peak_gib(dev))
    check(idx.n_emitted == EXPECT_K63_KMERS,
          f"k=63 n_emitted {idx.n_emitted} != {EXPECT_K63_KMERS}")
    check(idx.n_repaired_windows == 0, "repairs at k=63")
    check(fin_launches > 0, "k=63 finalize did not launch the kernel")
    for name in ("bucket", "meta", "nucs", "data", "offs"):
        check(getattr(idx.skl, name).device.type == dev.type,
              f"k=63 arena column {name} not on the card")

    times = {}
    jm0, rm0 = launches("jmajor"), launches("rowmajor")
    t = time.perf_counter()
    want = idx.counts_dict()
    times["counts_dict_s"] = time.perf_counter() - t
    check(launches("rowmajor") > rm0 and launches("jmajor") == jm0,
          "counts_dict did not run the row-major kernel alone")
    ckpt = os.path.join(tmp, "k63.npz")
    t = time.perf_counter()
    idx.save(ckpt)
    times["save_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loaded = Brisk.load(ckpt, batch=1024, window=512, device=dev)
    sync(dev)
    times["load_s"] = time.perf_counter() - t
    check(loaded.skl.bucket.device.type == dev.type, "load left the card")
    check(loaded.counts_dict() == want, "save -> load changed counts_dict")
    del loaded
    out = os.path.join(tmp, "k63.kff")
    t = time.perf_counter()
    kff.write_index_skl(out, idx.skl, idx.params)
    times["kff_write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    back, kk, mm = kff.read_index(out)
    times["kff_read_s"] = time.perf_counter() - t
    check((kk, mm) == (k, m) and back == want, "KFF read-back != counts_dict")
    with scan_calls() as scans:
        t = time.perf_counter()
        total = idx.query_file(path)
        sync(dev)
        times["query_s"] = time.perf_counter() - t
    check(total >= idx.n_emitted, f"k=63 query total {total} too small")
    check(any(name == "join_scan" for name, _, _ in scans),
          "the k=63 query_file did not launch join_scan")
    with scan_calls() as rekey:
        t = time.perf_counter()
        idx.reallocate()
        sync(dev)
        times["reallocate_s"] = time.perf_counter() - t
    check(any(name == "run_totals" for name, _, _ in rekey),
          "reallocate's compactions did not launch run_totals")
    scans += rekey
    p = idx.params
    check((p.k, p.m, p.b) == (63, 23, 15), f"reallocate gave {p}")
    check(idx.counts_dict() == want, "reallocate changed counts_dict")
    n = kernel_launches()
    check_enumerated(n, "the k=63 deployment")
    say("k63-stages", query_total=total, kff_bytes=os.path.getsize(out),
        npz_bytes=os.path.getsize(ckpt), peak_gib=peak_gib(dev),
        scan_calls=scans,
        **{k_: round(v, 3) for k_, v in times.items()})
    del idx
    s_max = sklstore.skl_dims(k, m, b)[1]
    res = kernel_vs_plain(*span, k, m, b, s_max, timed=True)
    say("kernel", at="k63-deploy", k=k, R=R, exact=True,
        **{key: v for key, v in res.items() if key != "R"})
    return dict(launches=n, kernel=res, scan_calls=scans)


def phase_k63_short(dev, tmp: str) -> dict:
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.io import fasta
    from brisk_tpu_torch.params import Parameters
    read_len = 150
    path = os.path.join(tmp, "synth_k63_150.fa")
    write_input(path, K63_BASES, read_len)
    idx = Brisk(Parameters(*K63), batch=4096, window=512, stack=4,
                device=dev)
    # the short-read route lays every record out itself; BatchPacker.pack
    # runs only for records longer than one lane buffer
    packed = {"calls": 0}
    pack = fasta.BatchPacker.pack

    def counted_pack(self, chunks):
        packed["calls"] += 1
        return pack(self, chunks)

    fasta.BatchPacker.pack = counted_pack
    reset_peak(dev)
    reset_launches()
    replays0 = graph_replays()
    try:
        with timed_state_machine(dev) as loop:
            t0 = time.perf_counter()
            idx.warmup(os.path.getsize(path), record_len_hint=read_len,
                       path=path)
            sync(dev)
            t1 = time.perf_counter()
            idx.insert_file(path)
            idx._drain()
            sync(dev)
            t2 = time.perf_counter()
        idx.finalize()
        sync(dev)
        t3 = time.perf_counter()
    finally:
        fasta.BatchPacker.pack = pack
    n = kernel_launches()
    check_enumerated(n, "the k=63 short-read insert")
    check(graph_replays() > replays0,
          "the k=63 short-read flushes replayed no graph")
    geo = idx._stream_geometry(read_len)
    insert_s, finalize_s = t2 - t1, t3 - t2
    say("k63-short", warmup_s=round(t1 - t0, 3), insert_s=insert_s,
        finalize_s=finalize_s, n_emitted=idx.n_emitted, l_new=geo.l_new,
        l_buf=geo.l_buf, slow_path_pack_calls=packed["calls"],
        loop_share_of_insert=loop["s"] / insert_s,
        kmers_per_s=idx.n_emitted / (insert_s + finalize_s),
        peak_gib=peak_gib(dev))
    check(idx.n_emitted == EXPECT_K63_SHORT_KMERS,
          f"k=63 short-read n_emitted {idx.n_emitted} != "
          f"{EXPECT_K63_SHORT_KMERS}")
    check(packed["calls"] == 0, "reads left the short-read route")
    check(n["jmajor"] > 0,
          "k=63 short-read finalize did not launch the kernel")
    return dict(launches=n)


def phase_counter_cli(tmp: str) -> None:
    from brisk_tpu_torch.io import kff
    from brisk_tpu_torch.oracle import pyref
    fa = os.path.join(REPO, "data", "test.fa")
    for k, m, b in ((K, M, B), K63):
        out = os.path.join(tmp, f"cli_k{k}.kff")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "brisk_tpu_torch.apps.counter", "-f", fa,
             "-k", str(k), "-m", str(m), "-b", str(b), "--mode", "2",
             "--device", "cuda", "-o", out],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=REPO))
        cli_s = time.perf_counter() - t
        lines = proc.stdout.splitlines()
        check(proc.returncode == 0,
              f"counter CLI k={k} exited {proc.returncode}:\n"
              f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        check("All counts are correct !" in lines,
              f"counter CLI k={k} did not verify:\n{proc.stdout[-2000:]}")
        back = kff.read_index(out)[0]
        check(back == pyref.count_fasta(fa, k, m),
              f"counter CLI k={k}: KFF read-back != counts")
        say("counter-cli", k=k, rc=proc.returncode, verified=True,
            kff_kmers=len(back), cli_s=round(cli_s, 2),
            device_line=next((ln for ln in lines
                              if ln.startswith("Devices:")), None))


def kernel_report(kern: dict, phases: dict) -> dict:
    """The closing kernel report: per kernel its route, source, the TPU
    kernel or XLA program it replaces, its launches summed over the
    main-path phases (each phase's dict holds its "launches"), its worst
    difference from its plain version and its times at the main path's
    first shape."""
    main_path = list(phases.values())
    con, shard, k63, trace = (phases[name] for name in (
        "consolidate", "sharded", "k63", "trace"))
    per_layout = {layout: sum(r["launches"][layout] for r in main_path)
                  for layout in ("jmajor", "rowmajor")}
    first = kern["shapes"][0]  # finalize k=31, 2^23 rows, J-major
    report = {"kernels": [{
        "name": "expand_span", "route": "cuda",
        "source": "brisk_tpu_torch/csrc/expand_span.cu",
        "replaces": "brisk_tpu/index/sklstore.py:725",
        "launches": sum(per_layout.values()),
        "launches_by_layout": per_layout,
        "max_abs_err": max(kern["max_abs_err"], con["kernel"]["max_abs_err"],
                           shard["kernel"]["max_abs_err"],
                           k63["kernel"]["max_abs_err"]),
        "ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None,
        "shapes": [{key: t.get(key) for key in (
            "shape", "layout", "R", "kernel_ms", "bound_ms",
            "share_of_bound", "fill_ms", "plain_ms", "old_path_ms")}
            for t in kern["shapes"]],
        "k63_R": k63["kernel"]["R"],
        "k63_jmajor_ms": k63["kernel"]["jmajor_ms"],
        "k63_jmajor_plain_ms": k63["kernel"]["jmajor_plain_ms"],
        "consolidate_R": con["kernel"]["R"],
        "consolidate_rowmajor_ms": con["kernel"]["rowmajor_ms"],
        "consolidate_rowmajor_plain_ms":
            con["kernel"]["rowmajor_plain_ms"],
        "sharded_launches_by_layout": shard["launches"],
        "sharded_R": shard["kernel"]["R"],
        "sharded_jmajor_ms": shard["kernel"]["jmajor_ms"],
        "sharded_jmajor_plain_ms": shard["kernel"]["jmajor_plain_ms"],
        "sharded_rowmajor_ms": shard["kernel"]["rowmajor_ms"],
        "sharded_bound_ms": shard["kernel"]["bound_ms"],
        "trace_launches_by_layout": trace["launches"]}]}
    sources = {"positions": ("brisk_tpu_torch/csrc/positions.cu",
                             "brisk_tpu/ops/minimizer.py:54"),
               "rescan": ("brisk_tpu_torch/csrc/rescan.cu",
                          "brisk_tpu/ops/minimizer.py:79"),
               "state_scan": ("brisk_tpu_torch/csrc/state_scan.cu",
                              "brisk_tpu/ops/enumerate.py:188"),
               "emit": ("brisk_tpu_torch/csrc/emit.cu",
                        "brisk_tpu/ops/enumerate.py:197"),
               "skl_rows": ("brisk_tpu_torch/csrc/skl_rows.cu",
                            "brisk_tpu/index/sklstore.py:168")}
    for name in ENUM_KERNELS:
        rows = [r for r in kern["enum"]["rows"] if r["kernel"] == name]
        first = rows[0]  # the insert's batch at the bench geometry
        report["kernels"].append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": sum(r["launches"][name] for r in main_path),
            "launches_by_phase": {phase: r["launches"][name]
                                  for phase, r in phases.items()},
            "max_abs_err": kern["enum"]["max_abs_err"][name],
            "ms": first["device_ms"], "call_ms": first["kernel_ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None,
            "geometries": [{key: r.get(key) for key in (
                "geometry", "k", "m", "B", "R", "L", "L_out", "row_cap",
                "device_ms",
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "share_of_bound", "bytes", "fp64_adds")} for r in rows]})
    calls = [(phase, name, n, ms) for phase, r in phases.items()
             for name, n, ms in r.get("scan_calls", ())]
    for name, source, replaces in (
            ("join_scan", "brisk_tpu_torch/csrc/run_scan.cu",
             "brisk_tpu/index/sklstore.py:1431"),
            ("run_totals", "brisk_tpu_torch/csrc/run_scan.cu",
             "brisk_tpu/index/store.py:199")):
        rows = [r for r in kern["scan"]["rows"] if r["kernel"] == name]
        # the deployment's query join; for run_totals the k=63 rekey
        first = rows[0]
        report["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"][name] for r in main_path),
            "launches_by_phase": {phase: r["launches"][name]
                                  for phase, r in phases.items()},
            "max_abs_err": kern["scan"]["max_abs_err"][name],
            "ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "shapes": [{key: r.get(key) for key in (
                "shape", "n", "W", "kernel_ms", "plain_ms", "library_ms",
                "bound_ms", "share_of_bound")} for r in rows],
            "main_path_calls": [
                dict(phase=phase, n=n, ms=ms)
                for phase, kname, n, ms in calls if kname == name]})
    for k in report["kernels"]:
        check(k["launches"] > 0 and k["max_abs_err"] == 0,
              f"{k['name']}: {k['launches']} launches on the main path, "
              f"max_abs_err {k['max_abs_err']}")
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, REPO)
    from brisk_tpu_torch import kernels
    from brisk_tpu_torch.index import sklstore

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    say("device", name=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda)
    t = time.perf_counter()
    logs = kernels.build(sorted({sklstore.skl_dims(*kmb)[1]
                                 for kmb, _ in KERNEL_SPANS}))
    say("build", seconds=round(time.perf_counter() - t, 2))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", kernel=name, ptxas=line.strip())

    spent = {}

    def run(name, fn, *args):
        """One phase, its wall seconds kept for the closing line."""
        t = time.perf_counter()
        out = fn(*args)
        spent[name] = round(time.perf_counter() - t, 1)
        return out

    kern = run("kernels", phase_kernels, dev)
    with tempfile.TemporaryDirectory() as tmp:
        run("fixtures", phase_fixtures, dev, tmp)
        dep = run("deploy", phase_deployment, dev, tmp)
        run("flush-graph", phase_flush_graph, dev, dep)
        con = run("consolidate", phase_consolidate, dev, dep)
        dep_launches = dict(launches=dep["launches"],
                            scan_calls=dep["scan_calls"])
        counter = {key: dep[key] for key in ("path", "sample", "direct",
                                             "got", "nb_kmers")}
        del dep
        torch.cuda.empty_cache()
        pay = run("payload", phase_payload, dev, counter)
        run("payload-graph", phase_insert_graph, dev, counter, "payload")
        run("payload-parity", phase_payload_parity, dev, tmp)
        # the CPU half of sharded-parity runs beside the card's phases
        ref = start_sharded_reference(tmp)
        try:
            shard = run("sharded", phase_sharded, dev, counter)
            run("sharded-graph", phase_insert_graph, dev, counter,
                "sharded")
            run("sharded-spill", phase_sharded_spill, dev, tmp)
            run("sharded-parity", phase_sharded_parity, dev, tmp, ref)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
        k63 = run("k63-deploy", phase_k63_deploy, dev, tmp)
        torch.cuda.empty_cache()
        short = run("k63-short", phase_k63_short, dev, tmp)
        run("counter-cli", phase_counter_cli, tmp)
        trace = run("trace", phase_trace, dev, tmp)
        torch.cuda.empty_cache()
        run("bench-quick", phase_bench_quick, start_bench_quick(tmp))
    say("phases", **spent, total_s=round(sum(spent.values()), 1))

    report = kernel_report(kern, dict(
        deploy=dep_launches, consolidate=con, payload=pay, sharded=shard,
        k63=k63, k63_short=short, trace=trace))
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-cpu-reference"]:
        sys.exit(sharded_cpu_reference(sys.argv[2]))
    sys.exit(main())
