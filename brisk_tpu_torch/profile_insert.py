"""Where the k <= 32 insert's time goes now that each flush is one CUDA
graph replay (index.flush_graph), on one CUDA card:

    python -m brisk_tpu_torch.profile_insert [--device cuda|cpu]
        [--bases N] [--data-dir DIR]

Prints the card's name and power limit, then JSON lines:
  - `flush`, one per path (`graph`: flush_graph.insert_flat, what Brisk
    runs; `eager`: pipeline.insert_flat_sklnative), at the bench
    geometry (k=31 m=11 b=8, batch 2048, window 512, stack 8; a random
    record, seed 7): the steady flush's wall ms (the mean of 10, each fed
    the chain the one before returned) and one steady flush traced
    (trace_insert.traced_call): its host launch calls by name, the
    device's kernels, busy ms, and `kernels_unlike_other_path`, the
    kernel names the two paths run a different number of times;
  - `pace`, on the N-base synthetic deployment (bench.synth_path, 10 kb
    records; chip_smoke.py's is 50,000,000 bases): the native parse s,
    io.windows pack_flat s over every flush, the copies of the packed
    flushes to the device s, and Brisk._insert_windowed of the parsed
    records (its producer thread packing, its consumer dispatching each
    flush) through each path in turns (graph, eager, graph, eager), s.
    The eager turns swap flush_graph.insert_flat for the eager program
    inside this measurement only; Brisk itself has no such switch.
On the CPU both paths run the eager program and the device fields are
null.
"""

import argparse
import contextlib
import json
import sys
import tempfile
import time

import numpy as np
import torch

from brisk_tpu_torch import bench
from brisk_tpu_torch.bench import sync

PATHS = ("graph", "eager")


def _flush_fn(path: str):
    from brisk_tpu_torch.index import flush_graph, pipeline
    return (flush_graph.insert_flat if path == "graph"
            else pipeline.insert_flat_sklnative)


def flush_profile(dev: torch.device, rec_bases: int = 24_000_000,
                  k: int = 31, m: int = 11, b: int = 8, batch: int = 2048,
                  window: int = 512, stack: int = 8, flushes: int = 10,
                  seed: int = 7) -> list:
    """The `flush` rows of the module note, one per path."""
    from brisk_tpu_torch import kernels, trace_insert
    from brisk_tpu_torch.index import pipeline, sklstore
    if dev.type == "cuda":
        kernels.build([sklstore.skl_dims(k, m, b)[1]])
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 4, rec_bases, dtype=np.uint8)
    stacks, packer = bench.pack_stacks(k, m, batch, window, stack, rec, 2,
                                       dev)
    row_cap = max(16, window // 4)
    static = (k, m, b, row_cap, packer.l_buf, packer.useful)
    nw = sklstore.skl_dims(k, m, b)[3]
    rcap = 1 << max(14, (2 * stack * batch * row_cap - 1).bit_length())
    rows, by_name = [], {}
    for path in PATHS:
        fn = _flush_fn(path)
        skl = sklstore.empty(rcap, 1 << 14, nw, dev)
        out = fn(skl, *stacks[0][:3], pipeline.zero_chain(dev), *static)

        def steady():
            nonlocal out
            fresh = out[0]._replace(n_rows=torch.zeros_like(out[0].n_rows))
            out = fn(fresh, *stacks[1][:3], out[6], *static)
            int(out[5])

        steady()
        sync(dev)
        t = time.perf_counter()
        for _ in range(flushes):
            steady()
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t) / flushes
        _, rec_ = trace_insert.traced_call(dev, "flush_" + path, steady,
                                           top=10 ** 6)
        by_name[path] = {r["name"]: r["launches"]
                         for r in rec_["top_kernels"] or ()}
        rows.append(dict(stage="flush", path=path, steady_flush_ms=wall_ms,
                         host_launch_calls=rec_["host_launch_calls"],
                         host_calls=rec_["host_calls"],
                         device_kernels=rec_["launches"],
                         memcpy_memset=rec_.get("memcpy_memset"),
                         busy_ms=rec_["busy_ms"],
                         traced_wall_ms=rec_["wall_ms"]))
    for row, other in zip(rows, reversed(PATHS)):
        mine, theirs = by_name[row["path"]], by_name[other]
        row["kernels_unlike_other_path"] = {
            name: n for name, n in mine.items() if theirs.get(name) != n}
    return rows


@contextlib.contextmanager
def _flushes_through(path: str):
    """Brisk's k <= 32 flushes through `path` inside the block."""
    from brisk_tpu_torch.index import flush_graph
    saved = flush_graph.insert_flat
    flush_graph.insert_flat = _flush_fn(path)
    try:
        yield
    finally:
        flush_graph.insert_flat = saved


def pace(dev: torch.device, data_dir: str, n_bases: int = 50_000_000,
         k: int = 31, m: int = 11, b: int = 8, batch: int = 2048,
         window: int = 512, stack: int = 8,
         turns: tuple = ("graph", "eager", "graph", "eager")) -> dict:
    """The `pace` row of the module note."""
    from brisk_tpu_torch import native
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.io import windows
    from brisk_tpu_torch.oracle import pyref
    from brisk_tpu_torch.params import Parameters
    path = bench.synth_path(data_dir, n_bases)

    def brisk():
        return Brisk(Parameters(k, m, b), batch=batch, window=window,
                     stack=stack, device=dev)

    t = time.perf_counter()
    recs = native.parse_fasta_codes(path)
    if recs is None:
        recs = list(pyref.read_fasta_chunks(path))
    parse_s = time.perf_counter() - t
    packer = windows.WindowPacker(k, m, batch, l_out=brisk().window)
    t = time.perf_counter()
    flushes = list(packer.pack_flat(iter(recs), stack))
    pack_s = time.perf_counter() - t
    sync(dev)
    t = time.perf_counter()
    staged = [tuple(torch.from_numpy(x).to(dev) for x in (
        fl.chunk4, fl.valid_start, fl.valid_end)) for fl in flushes]
    sync(dev)
    staging_s = time.perf_counter() - t
    del staged
    insert_s = {path_: [] for path_ in PATHS}
    emitted = set()
    for path_ in turns:
        br = brisk()
        br.warmup(n_bases)
        with _flushes_through(path_):
            sync(dev)
            t = time.perf_counter()
            br._insert_windowed(iter(recs))
            br._drain()
            sync(dev)
            insert_s[path_].append(time.perf_counter() - t)
        emitted.add(br.n_emitted)
    if len(emitted) != 1:
        raise RuntimeError(f"the turns emitted different counts: {emitted}")
    return dict(stage="pace", n_bases=n_bases, flushes=len(flushes),
                parse_s=parse_s, pack_flat_s=pack_s, staging_s=staging_s,
                insert_parsed_s=insert_s, n_emitted=emitted.pop())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the k <= 32 flush, graph against eager, and the "
                    "insert's pace")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bases", type=int, default=50_000_000,
                    help="bases of the synthetic deployment of `pace`")
    ap.add_argument("--data-dir", default=tempfile.gettempdir(),
                    help="where the deployment's input is written once")
    a = ap.parse_args(argv)
    dev = bench.device_of(a.device)
    info = bench.card_info(dev)
    print(f"{info['device_name']}, {info['power_limit_w']}", flush=True)
    for row in flush_profile(dev):
        print(json.dumps(row), flush=True)
    print(json.dumps(pace(dev, a.data_dir, a.bases)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
