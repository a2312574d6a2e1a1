"""Trace the three device programs of the main path with torch.profiler
(the counterpart of the repo's scripts/trace_insert.py):

    python -m brisk_tpu_torch.trace_insert [--device cuda|cpu] [--out DIR]
        [--deploy-bases N [--data-dir DIR]]

At the bench geometry (k=31 m=11 b=8, batch 2048, window 512, stack 8)
on an 8 Mb random record (seed 7): one flush into an empty arena as
Brisk runs it (`flush`: flush_graph.insert_flat, on a card one CUDA graph
replay of pipeline.insert_flat_sklnative's body and the arena's appends),
the same flush through the eager program into another empty arena
(`flush_eager`: pipeline.insert_flat_sklnative, the loop of torch ops and
kernel launches; the two arenas must be equal), sklstore.finalize_device
of the first arena (`finalize`), and the query_file route's join of a
small query
(the record's first 1 Mb, enumerated into a shadow arena outside the
span) against the finalized arena (`query_join`,
sklstore.query_join_total). Each program runs once to warm up, once
untraced (its wall time without the profiler's cost), then once under
torch.profiler (CPU and CUDA activities), each in a profiler session of
its own around a record_function span that this script opens and that
ends with a synchronize. A session holds one span's work and nothing
else, so its device events are the span's by membership, not by where
their timestamps fall: on the H100 the device timestamps have been seen
to land past the end of every span, and a time window over one session
for all three spans once counted no kernel in the join.

Writes one Chrome trace per span to DIR/trace_<span>.json (DIR defaults
to brisk_trace in the temp directory) and prints one JSON line per span:
the traced and untraced wall ms, CUDA kernel launches (`launches`: the
kernels the device ran, as CUPTI records them, one per kernel of a graph
replay too), the host's launch and copy calls (`host_launch_calls`: the
CUDA API calls (cuda*, cu*) on the CPU timeline that launch a kernel or
a graph or copy or set memory, by name in `host_calls`), device-busy ms
(the union of the kernel, memcpy and memset intervals of the session),
device_idle_share = 1 - busy / traced wall, the 10 kernels with the
most device time, the port's hand-written kernels that ran (launches and
device ms of each, by HAND_KERNELS; the query join's scan is join_scan),
and the device events whose timestamps fall outside the span (0 when the
clocks agree). With `--device cpu` the device
fields are null and the span's CPU op count is given.

`--deploy-bases N` also traces the user's query at a deployment's size
(`query_file`, trace_query_file): a Brisk at the same geometry built from
the N-base synthetic input of bench.synth_path (10 kb records, seed
1234; chip_smoke.py's deployment is 50,000,000 bases), then
Brisk.query_file of that input against it (the query's enumeration into
a shadow arena, both expansions and the join, whose scan covers the
index expansion and a query chunk of up to 2^26 slots), warmed, timed
untraced, then traced in a session of its own: one more JSON line, span
`query_file`. On a card, a
span whose session recorded no device activity is traced again (the
whole pass, up to 3 attempts, counted in `attempts`); if it never does,
the run raises instead of passing a CPU trace off as a device trace.

`--inserts` (with `--deploy-bases N`) also traces the two other insert
programs on that input's first flush, from a zero chain into a fresh
state (trace_inserts; warmed, timed untraced, traced): `payload_flush`
and `payload_flush_eager` (BriskData's flush, width 2 ("sum", "max"),
B 2048, W 512, S 8: flush_graph.insert_payload, one graph replay, and
pipeline.insert_windows_payload), `sharded_step` and
`sharded_step_eager` (ShardedBrisk's step, 8 shards x 256 lanes, W 512,
S 8, one process: flush_graph.insert_sharded and
sharded.sharded_insert_windows_sklonly); then for each of the two
indexes where a warm insert_file of the input goes (insert_breakdown,
from the program's spans: parse, packing, flushes, read-backs,
compactions, the rest)
and its insert_file with its flushes through the graph and the eager
program in turns (insert_turns).
"""

import argparse
import itertools
import json
import os
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from brisk_tpu_torch import bench
from brisk_tpu_torch.bench import sync

SPANS = ("flush", "flush_eager", "finalize", "query_join")
# the port's hand-written kernels by a part of their device functions'
# names (csrc/*.cu): kernels.LAUNCHES names, and the span expansion
HAND_KERNELS = {"expand_span": "expand_span_kernel",
                "positions": "positions_kernel", "rescan": "rescan_kernel",
                "state_scan": "state_scan_kernel", "emit": "emit_kernel",
                "skl_rows": "skl_rows_kernel", "join_scan": "join_scan_",
                "run_totals": "run_totals_"}
# the host calls that put work on the device (CUDA API names, cuda* and
# cu*, by prefix): kernel and graph launches, copies and memsets
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                     "cuMemset")


def _write_query(path: str, codes: np.ndarray, read_len: int = 10_000):
    letters = np.frombuffer(b"ACTG", dtype=np.uint8)[codes]
    with open(path, "w") as fh:
        for i, j in enumerate(range(0, len(codes), read_len)):
            fh.write(f">q{i}\n{letters[j:j + read_len].tobytes().decode()}\n")


def _run_programs(dev, stack_t, packer, query_path, params, geo,
                  span=lambda name: nullcontext()) -> dict:
    """The four spans (SPANS) on fresh arenas, each inside span(name) and
    ended by a synchronize: {name: wall ms}."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.index import flush_graph, pipeline, sklstore
    k, m, b = params.k, params.m, params.b
    row_cap = max(16, geo["window"] // 4)
    nw = sklstore.skl_dims(k, m, b)[3]
    flush_rows = geo["stack"] * geo["batch"] * row_cap
    rcap = 1 << max(14, (2 * flush_rows - 1).bit_length())
    skl, skl_eager = (sklstore.empty(rcap, 1 << 14, nw, dev)
                      for _ in range(2))
    static = (k, m, b, row_cap, packer.l_buf, packer.useful)
    chains = [pipeline.zero_chain(dev) for _ in range(2)]
    wall = {}

    @contextmanager
    def timed(name):
        sync(dev)
        with span(name):
            t = time.perf_counter()
            yield
            sync(dev)
            wall[name] = 1e3 * (time.perf_counter() - t)

    with timed("flush"):
        out = flush_graph.insert_flat(skl, *stack_t, chains[0], *static)
        skl = out[0]
        int(out[5])  # data-dependent readback (n_rows)
    with timed("flush_eager"):
        out = pipeline.insert_flat_sklnative(skl_eager, *stack_t, chains[1],
                                             *static)
        skl_eager = out[0]
        int(out[5])
    if not all(torch.equal(getattr(skl, f), getattr(skl_eager, f))
               for f in ("bucket", "meta", "nucs", "n_rows")):
        raise RuntimeError("the flush and the eager flush built different "
                           "arenas")
    del skl_eager
    with timed("finalize"):
        skl = sklstore.finalize_device(skl, k, m, b)
        int(skl.n_fin_kmers)
    shadow = Brisk(params, device=dev, **geo)
    shadow.insert_file(query_path)
    shadow._drain()
    box = [shadow.skl]
    shadow.skl = None
    with timed("query_join"):
        wall["query_total"] = sklstore.query_join_total(skl, box, k, m, b)
    return wall


def _union_ms(intervals) -> float:
    """Total length (ms) of the union of (start, end) intervals in us."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


class NoDeviceActivity(RuntimeError):
    """A span's profiler session recorded no CUDA activity."""


def span_summary(events, dev: torch.device, name: str,
                 top: int = 10) -> dict:
    """One span from the events of its own profiler session: launches,
    busy ms, idle share and top kernels on a card; the CPU op count on
    the CPU."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    sp = [e for e in cpu if e.name == name]
    if not sp:
        raise RuntimeError(f"span {name} missing from its trace")
    sp = sp[-1]
    lo, hi = sp.time_range.start, sp.time_range.end
    wall_ms = (hi - lo) / 1e3
    rec = dict(span=name, traced_wall_ms=wall_ms)
    if dev.type != "cuda":
        rec.update(launches=None, host_launch_calls=None, host_calls=None,
                   busy_ms=None, device_idle_share=None,
                   top_kernels=None, hand_kernels=None, outside_span=None,
                   cpu_ops=sum(
                       1 for e in cpu if e is not sp
                       and lo <= e.time_range.start
                       and e.time_range.end <= hi))
        return rec
    # the session's device events, less the span's own GPU annotation
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != name]
    kernels = [e for e in device
               if not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise NoDeviceActivity(f"the profiler recorded no CUDA activity "
                               f"in span {name}")
    busy = _union_ms((e.time_range.start, e.time_range.end)
                     for e in device)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    host_calls = {}
    for e in cpu:
        if (e.name.startswith(HOST_LAUNCH_CALLS)
                and lo <= e.time_range.start and e.time_range.end <= hi):
            host_calls[e.name] = host_calls.get(e.name, 0) + 1
    rec.update(launches=len(kernels),
               host_launch_calls=sum(host_calls.values()),
               host_calls=host_calls, busy_ms=busy,
               device_idle_share=1.0 - busy / wall_ms,
               memcpy_memset=len(device) - len(kernels),
               top_kernels=[dict(name=n[:120], launches=c, ms=t)
                            for n, (c, t) in sorted(
                                by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]],
               hand_kernels=_hand_kernels(by_name),
               outside_span=sum(1 for e in device
                                if e.time_range.start < lo
                                or e.time_range.end > hi),
               cpu_ops=None)
    return rec


def _hand_kernels(by_name: dict) -> dict:
    """{kernel: dict(launches, ms)} of the HAND_KERNELS among a span's
    kernels (by_name: device function name -> (launches, ms))."""
    out = {}
    for kernel, part in HAND_KERNELS.items():
        hits = [v for n, v in by_name.items() if part in n]
        if hits:
            out[kernel] = dict(launches=sum(c for c, _ in hits),
                               ms=sum(t for _, t in hits))
    return out


def _traced_pass(run, activities, out_dir: str):
    """The four spans, each in a profiler session of its own:
    ({name: wall ms}, {name: span summary}); writes trace_<span>.json."""
    from torch.profiler import profile, record_function
    dev = run[0]
    sessions = {}

    @contextmanager
    def span(name):
        with profile(activities=activities) as prof:
            with record_function(name):
                yield
        sessions[name] = prof

    wall = _run_programs(*run, span=span)
    summary = {}
    for name, prof in sessions.items():
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"trace_{name}.json"))
        summary[name] = span_summary(prof.events(), dev, name)
    return wall, summary


def trace(dev: torch.device, out_dir: str, rec_bases: int = 8_000_000,
          query_bases: int = 1_000_000, k: int = 31, m: int = 11,
          b: int = 8, batch: int = 2048, window: int = 512,
          stack: int = 8, seed: int = 7, attempts: int = 3) -> list:
    """Warm up, time untraced, then trace the four spans (see the module
    note); returns one summary dict per span, in SPANS order."""
    from torch.profiler import ProfilerActivity

    from brisk_tpu_torch import kernels
    from brisk_tpu_torch.index import sklstore
    from brisk_tpu_torch.params import Parameters
    params = Parameters(k, m, b)
    geo = dict(batch=batch, window=window, stack=stack)
    if dev.type == "cuda":
        kernels.build([sklstore.skl_dims(k, m, b)[1]])
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 4, rec_bases, dtype=np.uint8)
    stacks, packer = bench.pack_stacks(k, m, batch, window, stack, rec, 1,
                                       dev)
    stack_t = stacks[0][:3]
    os.makedirs(out_dir, exist_ok=True)
    query_path = os.path.join(out_dir, "query.fa")
    _write_query(query_path, rec[:query_bases])
    run = (dev, stack_t, packer, query_path, params, geo)
    _run_programs(*run)                      # warm-up
    untraced = _run_programs(*run)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for attempt in range(1, attempts + 1):
        try:
            traced, summary = _traced_pass(run, activities, out_dir)
            break
        except NoDeviceActivity:
            if attempt == attempts:
                raise
    if traced["query_total"] != untraced["query_total"]:
        raise RuntimeError("the traced query join disagrees with the "
                           "untraced one")
    rows = []
    for name in SPANS:
        rec_ = dict(summary[name], wall_ms=traced[name],
                    untraced_wall_ms=untraced[name], attempts=attempt)
        if name == "query_join":
            rec_["query_total"] = traced["query_total"]
        rows.append(rec_)
    return rows


def trace_query_file(dev: torch.device, out_dir: str, n_bases: int,
                     data_dir: str, k: int = 31, m: int = 11, b: int = 8,
                     batch: int = 2048, window: int = 512,
                     stack: int = 8) -> dict:
    """Brisk.query_file of the n_bases synthetic deployment against its own
    index, traced (see the module note): the span summary of
    `query_file`, with its wall and untraced wall ms and the query
    total; writes DIR/trace_query_file.json."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    path = bench.synth_path(data_dir, n_bases)
    idx = Brisk(Parameters(k, m, b), batch=batch, window=window,
                stack=stack, device=dev)
    idx.insert_file(path)
    idx.finalize()
    total = idx.query_file(path)  # warm-up
    sync(dev)
    t = time.perf_counter()
    untraced = idx.query_file(path)
    sync(dev)
    untraced_ms = 1e3 * (time.perf_counter() - t)
    traced, rec = traced_call(dev, "query_file",
                              lambda: idx.query_file(path), out_dir)
    if not total == untraced == traced:
        raise RuntimeError("the traced query_file disagrees with the "
                           "untraced one")
    return dict(rec, untraced_wall_ms=untraced_ms, n_bases=n_bases,
                query_total=traced)


def traced_call(dev: torch.device, name: str, fn, out_dir: str = None,
                top: int = 10):
    """fn() in a profiler session of its own, inside a record_function
    span `name` that ends with a synchronize: (fn's result, the span's
    summary with its wall ms and `top` kernels); writes
    DIR/trace_<name>.json when out_dir is given."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            t = time.perf_counter()
            out = fn()
            sync(dev)
            wall_ms = 1e3 * (time.perf_counter() - t)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    return out, dict(span_summary(prof.events(), dev, name, top),
                     wall_ms=wall_ms)


# -- the payload insert and the sharded step ------------------------------

INSERT_SPANS = ("payload_flush", "payload_flush_eager", "sharded_step",
                "sharded_step_eager")
# the deployments' geometries: BriskData (count, last position) and
# ShardedBrisk, 8 shards on one device, at the counter's lanes and window
PAYLOAD_GEOMETRY = dict(width=2, kinds=("sum", "max"), batch=2048,
                        window=512, stack=8)
SHARDED_GEOMETRY = dict(n_devices=8, batch_per_shard=256, window=512,
                        stack=8)


def _parsed(path: str):
    """path's records as the inserts read them (native uint8 codes, or
    ACGT strings from the Python parser)."""
    from brisk_tpu_torch import native
    from brisk_tpu_torch.oracle import pyref
    recs = native.parse_fasta_codes(path)
    return list(recs) if recs is not None else list(
        pyref.read_fasta_chunks(path))


def _first_stacks(packer, path: str, stack: int, n: int, stage) -> list:
    """stage(batches) of the first n stacks of `stack` window batches
    that packer packs from path; raises when path has fewer."""
    stacks, pending = [], []
    for bt in packer.pack(iter(_parsed(path))):
        pending.append(bt)
        if len(pending) == stack:
            stacks.append(stage(pending))
            pending = []
            if len(stacks) == n:
                return stacks
    raise ValueError(f"{path} packs {len(stacks)} full flushes, not {n}")


def payload_stacks(dev: torch.device, path: str, n: int, k: int = 31,
                   m: int = 11, b: int = 8, **geo) -> tuple:
    """The first n flushes of path as BriskData stages them on dev
    (PAYLOAD_GEOMETRY unless given): (the BriskData, [(codes,
    valid_start, valid_end, pos0)], static (k, m, b, width), columns a
    flush appends)."""
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.io import windows
    from brisk_tpu_torch.params import Parameters
    bd = BriskData(Parameters(k, m, b), device=dev,
                   **dict(PAYLOAD_GEOMETRY, **geo))
    packer = windows.WindowPacker(k, m, bd.batch, l_out=bd.window)
    stacks = _first_stacks(packer, path, bd.stack, n,
                           lambda st: bd._stage(packer, st))
    return (bd, stacks, (k, m, b, bd.width),
            bd.stack * bd.batch * packer.l_out)


def sharded_stacks(dev: torch.device, path: str, n: int, k: int = 31,
                   m: int = 11, b: int = 8, **geo) -> tuple:
    """The first n steps of path as ShardedBrisk stages them on dev
    (SHARDED_GEOMETRY unless given): (the ShardedBrisk, [(codes,
    valid_start, valid_end)], the static tail (k, m, b, mesh, row_cap,
    skl_route_cap), rows a step appends per shard)."""
    from brisk_tpu_torch.io import windows
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    sb = ShardedBrisk(Parameters(k, m, b), device=dev,
                      **dict(SHARDED_GEOMETRY, **geo))
    packer = windows.WindowPacker(k, m, sb.B, l_out=sb.window)
    laid = list(itertools.islice(
        packer.record_stacks(_parsed(path), sb.stack), n))
    if len(laid) < n or laid[-1].batches[-1].rec[-1] < 0:
        raise ValueError(f"{path} lays out fewer than {n} full stacks")
    stacks = [sb._stage(st) for st in laid]
    per_step = sb.stack * (sb.n_shards * sb.skl_route_cap
                           + sb.B_local * sb.skl_row_cap)
    return (sb, stacks, (k, m, b, sb.mesh, sb.skl_row_cap,
                         sb.skl_route_cap), per_step)


def insert_programs(dev: torch.device, path: str, n: int,
                    which: str) -> dict:
    """The payload insert (which="payload") or the sharded step
    ("sharded") on the first n flushes of path at its deployment's
    geometry: {span: (program (state, i, chain) -> its tuple, the index
    of n_km and of the chain in the tuple, a fresh state for n
    flushes)}, its two INSERT_SPANS (the graph runner, then the eager
    program)."""
    from brisk_tpu_torch.index import flush_graph, payload, pipeline
    from brisk_tpu_torch.parallel import sharded

    def run(fn, stacks, static):
        return lambda st, i, ch: fn(st, *stacks[i], ch, *static)

    if which == "payload":
        bd, stacks, static, cols = payload_stacks(dev, path, n)

        def state():
            return payload.empty(n * cols, bd.W, bd.width, dev)

        return {"payload_flush": (run(flush_graph.insert_payload, stacks,
                                      static), (1, 4), state),
                "payload_flush_eager": (run(pipeline.insert_windows_payload,
                                            stacks, static), (1, 4), state)}
    sb, stacks, tail, per_step = sharded_stacks(dev, path, n)
    rcap = 1 << max(12, (n * per_step - 1).bit_length())

    def state():
        return sharded.sharded_skl_empty(sb.n_shards, rcap, 1 << 12,
                                         sb._skl_nw, sb.mesh)

    return {"sharded_step": (run(flush_graph.insert_sharded, stacks, tail),
                             (2, 7), state),
            "sharded_step_eager": (run(sharded.sharded_insert_windows_sklonly,
                                       stacks, tail), (2, 7), state)}


def trace_inserts(dev: torch.device, out_dir: str, path: str) -> list:
    """One flush of each INSERT_SPANS program from a zero chain into a
    fresh state, at the deployments' geometries on path's first flush:
    once to warm up (the graphs' captures), once untraced, once traced
    (traced_call); one summary dict per span, in INSERT_SPANS order, with
    its untraced wall ms and k-mer count."""
    from brisk_tpu_torch.index import pipeline
    programs = {**insert_programs(dev, path, 1, "payload"),
                **insert_programs(dev, path, 1, "sharded")}
    rows = []
    for name in INSERT_SPANS:
        fn, (km_at, _), state = programs[name]

        def flush():
            return int(fn(state(), 0, pipeline.zero_chain(dev))[km_at])

        flush()
        sync(dev)
        t = time.perf_counter()
        n_km = flush()
        sync(dev)
        untraced_ms = 1e3 * (time.perf_counter() - t)
        traced, rec = traced_call(dev, name, flush, out_dir)
        if traced != n_km:
            raise RuntimeError(f"the traced {name} disagrees with the "
                               f"untraced one")
        rows.append(dict(rec, untraced_wall_ms=untraced_ms, n_km=n_km))
    return rows


def insert_breakdown(dev: torch.device, path: str, which: str) -> dict:
    """Where one insert_file of path goes for `which` ("payload":
    BriskData; "sharded": ShardedBrisk) at its deployment's geometry:
    after a warm-up insert (the graph captured), one insert untimed, then
    one under spans.recording(), whose spans give the own seconds and
    the count of the native parse, the packing (`pack_calls`: each next()
    of WindowPacker.pack, or for ShardedBrisk the window table and each
    next() of its stacks, the one that finds it exhausted too, and each
    stack's staging copies), the flushes (the graph replay and the
    appends), the read-backs to the host (a flush's outputs, a repair's
    end states) and the payload compactions; `rest_s` is the insert less
    those (the room checks, repairs and host bookkeeping). Nothing
    synchronizes inside the insert."""
    from brisk_tpu_torch import spans
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel.facade import ShardedBrisk

    def insert():
        idx = (BriskData(Parameters(31, 11, 8), device=dev,
                         **PAYLOAD_GEOMETRY) if which == "payload" else
               ShardedBrisk(Parameters(31, 11, 8), device=dev,
                            **SHARDED_GEOMETRY))
        sync(dev)
        t = time.perf_counter()
        idx.insert_file(path)
        sync(dev)
        return time.perf_counter() - t, idx

    insert()
    untimed_s, _ = insert()
    spans.clear()
    with spans.recording():
        insert_s, idx = insert()
    recs = spans.records()
    spans.clear()
    row = dict(stage="insert_breakdown", which=which, path=path,
               insert_untimed_s=untimed_s, insert_s=insert_s,
               n_emitted=idx.n_emitted)
    keys = dict(parse="parse", pack="pack", flush="flush",
                read_back="readback", compact="compact")
    for key, name in keys.items():
        own = [ns for r, ns in zip(recs, spans.self_ns(recs))
               if r.name == name and r.kind != "call"]
        row[f"{key}_s"], row[f"{key}_calls"] = sum(own) / 1e9, len(own)
    row["rest_s"] = insert_s - sum(row[f"{key}_s"] for key in keys)
    return row


def insert_turns(dev: torch.device, path: str, which: str,
                 turns: tuple = ("graph", "eager", "graph", "eager")
                 ) -> dict:
    """insert_file of path by a fresh index of `which` ("payload":
    BriskData; "sharded": ShardedBrisk) at its deployment's geometry,
    its flushes through the graph runner or the eager program in turns,
    after one warm-up insert through each (the graph captured): the
    seconds of each turn, by path. The eager turns swap flush_graph's
    entry point for the eager program inside this measurement only."""
    from brisk_tpu_torch.data_api import BriskData
    from brisk_tpu_torch.index import flush_graph, pipeline
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel import sharded
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    name, eager = (("insert_payload", pipeline.insert_windows_payload)
                   if which == "payload" else
                   ("insert_sharded", sharded.sharded_insert_windows_sklonly))
    graph = getattr(flush_graph, name)
    seconds = {"graph": [], "eager": []}
    emitted = set()
    for i, turn in enumerate(("graph", "eager") + tuple(turns)):
        idx = (BriskData(Parameters(31, 11, 8), device=dev,
                         **PAYLOAD_GEOMETRY) if which == "payload" else
               ShardedBrisk(Parameters(31, 11, 8), device=dev,
                            **SHARDED_GEOMETRY))
        setattr(flush_graph, name, graph if turn == "graph" else eager)
        try:
            sync(dev)
            t = time.perf_counter()
            idx.insert_file(path)
            sync(dev)
            if i >= 2:  # the first two warm up
                seconds[turn].append(time.perf_counter() - t)
        finally:
            setattr(flush_graph, name, graph)
        emitted.add(idx.n_emitted)
    if len(emitted) != 1:
        raise RuntimeError(f"the turns emitted different counts: {emitted}")
    return dict(stage="insert_turns", which=which, insert_s=seconds,
                n_emitted=emitted.pop())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="torch.profiler trace of flush, finalize and query join")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "brisk_trace"))
    ap.add_argument("--deploy-bases", type=int, default=0,
                    help="also trace query_file at a deployment of this "
                         "many bases (0: no)")
    ap.add_argument("--data-dir", default=tempfile.gettempdir(),
                    help="where the deployment's input is written once")
    ap.add_argument("--inserts", action="store_true",
                    help="with --deploy-bases: also trace the payload "
                         "insert and the sharded step (INSERT_SPANS), "
                         "break each one's insert_file down and time it "
                         "graph / eager in turns")
    a = ap.parse_args(argv)
    if a.inserts and not a.deploy_bases:
        ap.error("--inserts needs --deploy-bases")
    dev = bench.device_of(a.device)
    info = bench.card_info(dev)
    print(f"{info['device_name']}, {info['power_limit_w']}", flush=True)
    for row in trace(dev, a.out):
        print(json.dumps(row), flush=True)
    if a.deploy_bases:
        print(json.dumps(trace_query_file(dev, a.out, a.deploy_bases,
                                          a.data_dir)), flush=True)
    if a.inserts:
        path = bench.synth_path(a.data_dir, a.deploy_bases)
        for row in trace_inserts(dev, a.out, path):
            print(json.dumps(row), flush=True)
        for which in ("payload", "sharded"):
            print(json.dumps(insert_breakdown(dev, path, which)),
                  flush=True)
            print(json.dumps(insert_turns(dev, path, which)), flush=True)
    print(f"traces written to {os.path.join(a.out, 'trace_<span>.json')}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
