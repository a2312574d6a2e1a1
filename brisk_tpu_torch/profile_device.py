"""Stage-by-stage times of the k <= 32 insert on one CUDA card (the
counterpart of the repo's scripts/profile_device.py):

    python -m brisk_tpu_torch.profile_device [--device cuda|cpu]

At the reference's geometry, k=31 m=11 b=8, B=4096 lanes of L=1024
positions, S=8 batches, on random codes (seed 1234), each stage's
median of 3 timed calls after a warm one (host clock, synchronize on
both sides) in ms and Mkmer/s:

  position_pipeline       ops.minimizer.position_pipeline (1 batch)
  pipeline+rescan         position_pipeline + windowed_get_minimizer
  enumerate_batch         ops.enumerate.enumerate_batch (1 batch)
  insert_flat_sklnative   index.pipeline.insert_flat_sklnative, one flush
                          of S batches into an empty arena
  insert+finalize         the same flush, then sklstore.finalize_device
  finalize_device         sklstore.finalize_device alone, each call on a
                          fresh flush's arena (the flush off the clock)

The last two stand where the reference times its legacy per-k-mer
insert_many and store.compact_auto, which the port does not have: the
product insert and its finalize are what Brisk.insert_file and
Brisk.finalize run. On a card five more rows time the enumerator's
kernels alone on one batch (bench_enumerate.measure, held to their plain
versions first), each with its ms per call, device_ms, plain_ms and
bound_ms:

  skl_rows                kernels.skl_rows (the super-k-mer rows of the
                          batch's emissions)
  emit                    kernels.emit (the epilogue after the scan)
  state_scan              kernels.state_scan (the per-position state
                          machine)
  rescan                  kernels.rescan (get_minimizer at every
                          position)
  positions               kernels.positions (the position pipeline)

Then what the host issues per enumerate_batch call (`op_counts`): the
non-view torch ops (counted by a TorchDispatchMode; views launch
nothing) and the hand-kernel launches, at k=31 windowed (the insert) and
k=63 streaming; the counts do not depend on the lane count.

On a card the stages also report the device memory: the peak allocated
over their timed calls (`peak_gib`) and the segments the caching
allocator took from the driver during them (`cuda_mallocs`, after a
first warm call; more than 0 means a call's allocations did not fit the
cache).

Prints the card's name and power limit, then one JSON line per stage. A
CPU run (`--device cpu`) gives host times, has no kernel rows, and counts
the plain versions' ops.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from brisk_tpu_torch import bench


def _segments(dev: torch.device) -> int:
    """cudaMalloc calls of the caching allocator so far."""
    return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)


def _memory(dev: torch.device, segments: int) -> dict:
    """peak_gib since the last peak reset and cuda_mallocs since the
    `segments` count."""
    return dict(peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                cuda_mallocs=_segments(dev) - segments)


def timed(dev, label: str, fn, per: int) -> dict:
    """One stage's row: bench.median_s of fn, and the k-mer rate for
    `per` k-mers; on a card also its memory (module note) over the
    median's calls, after one more warm call."""
    if dev.type == "cuda":
        fn()
        bench.sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        segments = _segments(dev)
    t = bench.median_s(dev, fn)
    row = dict(stage=label, ms=1e3 * t, mkmer_per_s=per / t / 1e6, calls=3)
    if dev.type == "cuda":
        row.update(_memory(dev, segments))
    return row


def timed_after(dev, label: str, setup, fn, per: int, n: int = 3) -> dict:
    """A row like timed's for fn(setup()) with setup off the clock: the
    median of n calls after a warm one, each on a fresh setup() and
    between synchronizes; the memory over the n timed calls of fn."""
    times = []
    for i in range(n + 1):
        x = setup()
        bench.sync(dev)
        if i == 1 and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            segments = _segments(dev)
        t0 = time.perf_counter()
        int(fn(x))
        bench.sync(dev)
        if i:
            times.append(time.perf_counter() - t0)
        del x
    t = sorted(times)[len(times) // 2]
    row = dict(stage=label, ms=1e3 * t, mkmer_per_s=per / t / 1e6, calls=n)
    if dev.type == "cuda":
        row.update(_memory(dev, segments))
    return row


def profile(dev: torch.device, k: int = 31, m: int = 11, b: int = 8,
            batch: int = 4096, length: int = 1024, stack: int = 8) -> list:
    """The stages of the module note at the given geometry: one dict per
    stage."""
    from brisk_tpu_torch import kernels
    from brisk_tpu_torch.index import pipeline, sklstore
    from brisk_tpu_torch.ops import enumerate as enum_ops
    from brisk_tpu_torch.ops import minimizer
    if dev.type == "cuda":
        kernels.build([sklstore.skl_dims(k, m, b)[1]])
    margin = k - 1
    l_buf = margin + length
    rng = np.random.default_rng(1234)
    codes = torch.from_numpy(rng.integers(0, 4, (batch, l_buf),
                                          dtype=np.uint8)).to(dev)
    codes = codes.to(torch.int64)
    fresh = torch.ones(batch, dtype=torch.bool, device=dev)
    valid_end = torch.full((batch,), l_buf, dtype=torch.int32, device=dev)
    carry = enum_ops.zero_carry(batch, dev)
    one = batch * length
    rows = []

    def pp():
        pa = minimizer.position_pipeline(codes, k, m)
        return pa.cand_hash[2][:, -1] + pa.fwd_k[0][:, -1]

    rows.append(timed(dev, "position_pipeline", pp, one))

    def rescan():
        pa = minimizer.position_pipeline(codes, k, m)
        st = minimizer.windowed_get_minimizer(pa, pa.fwd_k, k, m)
        return st.hash_lo[:, -1] + st.pos[:, -1]

    rows.append(timed(dev, "pipeline+rescan", rescan, one))

    def enum():
        em, end = enum_ops.enumerate_batch(codes, fresh, valid_end, carry,
                                           k, m, b)
        return em.key[0, :, -1] + end.pos

    rows.append(timed(dev, "enumerate_batch", enum, one))

    rec = rng.integers(0, 4, stack * batch * length, dtype=np.uint8)
    stacks, packer = bench.pack_stacks(k, m, batch, length, stack, rec, 1,
                                       dev)
    chunk4, vs, ve, n_kmers = stacks[0]
    row_cap = max(16, length // 4)
    nw = sklstore.skl_dims(k, m, b)[3]
    rcap = 1 << (stack * batch * row_cap - 1).bit_length()

    def insert():
        skl = sklstore.empty(rcap, 1 << 14, nw, dev)
        return pipeline.insert_flat_sklnative(
            skl, chunk4, vs, ve, pipeline.zero_chain(dev), k, m, b,
            row_cap, packer.l_buf, packer.useful)

    def finalize(out):
        return sklstore.finalize_device(out[0], k, m, b).n_fin_kmers

    rows.append(timed(dev, "insert_flat_sklnative",
                      lambda: insert()[0].n_rows, n_kmers))
    rows.append(timed(dev, "insert+finalize", lambda: finalize(insert()),
                      n_kmers))
    rows.append(timed_after(dev, "finalize_device", insert, finalize,
                            n_kmers))
    if dev.type == "cuda":
        from brisk_tpu_torch import bench_enumerate
        for r in reversed(bench_enumerate.measure(
                "profile", (k, m, b), batch, length, True, dev)):
            rows.append(dict(stage=r["kernel"], ms=r["kernel_ms"],
                             mkmer_per_s=one / r["kernel_ms"] / 1e3,
                             calls=10, device_ms=r["device_ms"],
                             plain_ms=r["plain_ms"],
                             bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                             max_abs_err=r["max_abs_err"]))
    for r in rows:
        r.update(k=k, batch=batch, length=length, stack=stack)
    return rows


def op_counts(dev: torch.device, batch: int = 64, length: int = 512
              ) -> list:
    """Non-view torch ops and kernel launches of one enumerate_batch call
    per configuration: k=31 m=11 windowed (valid_start 20 positions in),
    k=63 m=21 streaming; random codes (seed 1234), every lane fresh."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from brisk_tpu_torch import kernels
    from brisk_tpu_torch.ops import enumerate as enum_ops

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops += 1
            return func(*args, **(kwargs or {}))

    rows = []
    for k, m, b, windowed in ((31, 11, 8, True), (63, 21, 14, False)):
        rng = np.random.default_rng(1234)
        l_buf = k - 1 + length
        codes = torch.from_numpy(rng.integers(0, 4, (batch, l_buf),
                                              dtype=np.uint8)).to(dev)
        fresh = torch.ones(batch, dtype=torch.bool, device=dev)
        valid_end = torch.full((batch,), l_buf, dtype=torch.int32,
                               device=dev)
        vs = (torch.full((batch,), k - 1 + 20, dtype=torch.int32,
                         device=dev) if windowed else None)
        carry = enum_ops.zero_carry(batch, dev)
        enum_ops.enumerate_batch(codes, fresh, valid_end, carry, k, m, b,
                                 valid_start=vs)  # warm: builds, caches
        before = dict(kernels.LAUNCHES)
        with Count() as count:
            enum_ops.enumerate_batch(codes, fresh, valid_end, carry, k, m,
                                     b, valid_start=vs)
        launched = {name: n - before[name]
                    for name, n in kernels.LAUNCHES.items()
                    if n > before[name]}
        rows.append(dict(stage="enumerate_batch_ops", k=k, m=m,
                         windowed=windowed, batch=batch, length=length,
                         torch_ops=count.ops, kernel_launches=launched))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-stage times of the k <= 32 insert")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    dev = bench.device_of(a.device)
    info = bench.card_info(dev)
    print(f"{info['device_name']}, {info['power_limit_w']}", flush=True)
    for row in profile(dev) + op_counts(dev):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
