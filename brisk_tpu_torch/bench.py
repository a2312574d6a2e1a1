"""Benchmark of the port's product paths on one CUDA card (the counterpart
of the repo's top-level bench.py):

    python -m brisk_tpu_torch.bench [--device cuda|cpu] [--quick]
                                    [--stages a,b,...] [--data-dir DIR]

Prints the card's name and power limit, then ONE JSON line. Every stage
either reports its fields or an explicit `<stage>_error`, and the run
then exits 3; the primary metric (`product`) is not caught and kills the
run. Stages, one function each (the reference's names where the meaning
is the same):

  product    product_device_bench: steady-state
             pipeline.insert_flat_sklnative (one CUDA graph replay a flush,
             flush_graph) over packed window stacks of a random record
             (`value`, k-mers/s).
  e2e        e2e_bench: Brisk.warmup, insert_file and finalize on a 50 Mb
             synthetic genome at k=31, then skl_stats and query_file.
  expand     expand_bench: the span-expansion kernel at 2^23 rows, k=31,
             J-major, against its byte bound (bench_expand).
  k63        k63_e2e_bench: k=63 on 4.6 Mb of 10 kb records.
  k63_short  k63_short_read_bench: k=63 on 4.6 Mb of 150 bp reads.
  scale500   scale_500mb_bench: 500 Mb through the mid-ingest segment
             finalizes; segments, overflows, peak host RSS and device
             memory.
  sharded    sharded_overhead: one ShardedBrisk insert step (the flush of
             one window stack) at 1 and 8 shards on the one card, the same
             lanes and stack.

Timing: a host clock around work that ends in torch.cuda.synchronize()
(and, where the reference reads a count back, that readback as well).
`--quick` scales every input by ~1/50 (the 500 Mb stage becomes 10 Mb
with a lower segment_rows, so it still finalizes mid-ingest); it is for
the smoke run and the tests. Inputs come from io.synth (seed 1234) and
are written once into `--data-dir` (the temp directory by default).
Runs on the first CUDA card unless `--device cpu` is given; a CPU run
reports no device time (the kernel-time fields are null) and its rates
are host rates.
"""

import argparse
import itertools
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

# the reference C++ counter's rates on a 2-thread CPU host (BASELINE.md)
E2E_REF_KMERS_PER_S = 1.47e6    # 50 Mb, k=31
DEV_REF_KMERS_PER_S = 4.43e6    # 4.6 Mb, k=31
K63_REF_KMERS_PER_S = 0.27e6    # 4.6 Mb, k=63

STAGES = ("product", "e2e", "expand", "k63", "k63_short", "scale500",
          "sharded")
# keyword arguments of each stage function under --quick (the full run
# takes the functions' defaults)
QUICK = dict(
    product=dict(rec_bases=480_000),
    e2e=dict(n_bases=1_000_000),
    expand=dict(rows=1 << 17),
    k63=dict(n_bases=92_000),
    k63_short=dict(n_bases=92_000),
    scale500=dict(n_bases=10_000_000, segment_rows=1 << 20),
    sharded={},  # one step is one stack at the full geometry already
)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_s(dev: torch.device, fn, n: int = 3) -> float:
    """Median wall seconds of n calls of fn() after a warm one, each
    between synchronizes; fn returns a tensor or a list of tensors whose
    first elements are read back (a data-dependent barrier)."""
    def call():
        out = fn()
        for x in out if isinstance(out, (list, tuple)) else [out]:
            int(x.reshape(-1)[0])
    call()
    times = []
    for _ in range(n):
        sync(dev)
        t0 = time.perf_counter()
        call()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def device_of(name: str) -> torch.device:
    """`cuda` (the first card) or `cpu`; a CUDA device needs a card."""
    from brisk_tpu_torch.api import _device
    dev = _device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them (null on
    the CPU)."""
    if dev.type != "cuda":
        return dict(device_name="cpu", power_limit_w=None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    name, limit = (x.strip() for x in smi[dev.index or 0].split(","))
    return dict(device_name=name, power_limit_w=limit)


def synth_path(data_dir: str, n_bases: int, read_len: int = 10_000,
               seed: int = 1234) -> str:
    """The synthetic FASTA of (n_bases, read_len, seed) in data_dir,
    written once (io.synth) and reused."""
    from brisk_tpu_torch.io import synth
    path = os.path.join(data_dir,
                        f"bench_synth_{n_bases}_{read_len}_{seed}.fa")
    if not os.path.exists(path):
        os.makedirs(data_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        synth.write_synth(tmp, n_bases, read_len=read_len, seed=seed)
        os.replace(tmp, path)
    return path


def peak_gib(dev: torch.device):
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def pack_stacks(k: int, m: int, batch: int, window: int, stack: int,
                rec: np.ndarray, n_stacks: int, dev: torch.device):
    """The first n_stacks packed flushes (io.windows.pack_flat) of one
    record on `dev`: [(chunk4, valid_start, valid_end, n_kmers)], and the
    packer."""
    from brisk_tpu_torch.io import windows
    packer = windows.WindowPacker(k, m, batch=batch, l_out=window)
    stacks = []
    for fl in packer.pack_flat(iter([rec]), stack):
        stacks.append((
            torch.from_numpy(fl.chunk4).to(dev),
            torch.from_numpy(fl.valid_start.reshape(stack, batch)).to(dev),
            torch.from_numpy(fl.valid_end.reshape(stack, batch)).to(dev),
            int(fl.n_kmers)))
        if len(stacks) == n_stacks:
            break
    return stacks, packer


def product_device_bench(dev: torch.device, rec_bases: int = 24_000_000,
                         k: int = 31, m: int = 11, b: int = 8,
                         batch: int = 2048, window: int = 512,
                         stack: int = 8, n_stacks: int = 3,
                         trials: int = 3) -> dict:
    """Steady-state rate of the product insert program
    (pipeline.insert_flat_sklnative through flush_graph.insert_flat: what
    Brisk.insert_file dispatches for k <= 32, one CUDA graph replay a
    flush on the card) on `n_stacks` packed stacks of one random record,
    best of `trials`; the arena's n_rows is reset between trials."""
    from brisk_tpu_torch.index import flush_graph, pipeline, sklstore
    row_cap = max(16, window // 4)
    rng = np.random.default_rng(1234)
    rec = rng.integers(0, 4, rec_bases, dtype=np.uint8)
    stacks, packer = pack_stacks(k, m, batch, window, stack, rec, n_stacks,
                                 dev)
    nw = sklstore.skl_dims(k, m, b)[3]
    flush_rows = stack * batch * row_cap
    skl = sklstore.empty(1 << max(14, (4 * flush_rows - 1).bit_length()),
                         1 << 14, nw, dev)
    chain = pipeline.zero_chain(dev)

    def flush(sk, ch, st):
        out = flush_graph.insert_flat(
            sk, st[0], st[1], st[2], ch, k, m, b, row_cap, packer.l_buf,
            packer.useful)
        return out[0], out[6], out[5]

    skl, chain, n_rows = flush(skl, chain, stacks[0])  # warm
    int(n_rows)
    skl = skl._replace(n_rows=torch.zeros_like(skl.n_rows))
    n_kmers = sum(st[3] for st in stacks)
    times = []
    for _ in range(trials):
        sync(dev)
        t0 = time.perf_counter()
        for st in stacks:
            skl, chain, n_rows = flush(skl, chain, st)
        rows = int(n_rows)  # data-dependent readback
        sync(dev)
        times.append(time.perf_counter() - t0)
        skl = skl._replace(n_rows=torch.zeros_like(skl.n_rows))
    value = n_kmers / min(times)
    return dict(metric="product_device_kmers_per_sec_single_chip_k31",
                value=round(value), unit="kmers/s",
                vs_baseline=round(value / DEV_REF_KMERS_PER_S, 2),
                product_stacks=len(stacks), product_kmers=n_kmers,
                product_rows_per_trial=rows,
                product_trial_s=[round(t, 4) for t in times])


def _e2e_run(br, path: str, dev: torch.device, warmup_kw: dict) -> dict:
    """warmup -> insert_file -> finalize of one Brisk: stage seconds."""
    t_cold0 = time.perf_counter()
    br.warmup(os.path.getsize(path), path=path, **warmup_kw)
    sync(dev)
    t0 = time.perf_counter()
    br.insert_file(path)
    int(br.skl.n_rows)  # completion barrier with a readback
    sync(dev)
    t1 = time.perf_counter()
    br.finalize()
    int(br.skl.n_fin_kmers)
    sync(dev)
    t2 = time.perf_counter()
    return dict(cold=t_cold0, t0=t0, t1=t1, t2=t2)


def e2e_bench(dev: torch.device, data_dir: str, n_bases: int = 50_000_000,
              read_len: int = 10_000, k: int = 31, m: int = 11, b: int = 8,
              batch: int = 2048, window: int = 512, stack: int = 8) -> dict:
    """Brisk.insert_file + finalize on a synthetic genome after
    Brisk.warmup (e2e_warm), then skl_stats and a whole-file query_file
    against the finalized index. `e2e_cold` also counts warmup, which on
    the card includes building and loading the CUDA kernels (nvcc, unless
    the build directory already holds them) and the native parser."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    path = synth_path(data_dir, n_bases, read_len)
    br = Brisk(Parameters(k, m, b), batch=batch, window=window, stack=stack,
               device=dev)
    reset_peak(dev)
    t = _e2e_run(br, path, dev, {})
    n = br.n_emitted
    warm = t["t2"] - t["t0"]
    out = dict(
        e2e_warm_kmers_per_sec=round(n / warm),
        e2e_cold_kmers_per_sec=round(n / (t["t2"] - t["cold"])),
        e2e_warm_vs_cpu_ref=round(n / warm / E2E_REF_KMERS_PER_S, 2),
        stage_warmup_s=round(t["t0"] - t["cold"], 3),
        stage_insert_s=round(t["t1"] - t["t0"], 3),
        stage_finalize_s=round(t["t2"] - t["t1"], 3),
        e2e_nb_kmers=n,
        e2e_repaired_windows=br.n_repaired_windows,
        e2e_skl_overflows=br.n_skl_overflows,
    )
    ss = br.skl_stats()
    out.update(resident_bytes_per_kmer=round(ss["bytes_per_kmer"], 2),
               avg_kmers_per_superkmer_row=round(ss["avg_kmers_per_skl"], 2))
    sync(dev)
    t3 = time.perf_counter()
    total = br.query_file(path)
    sync(dev)
    t4 = time.perf_counter()
    out.update(query_file_kmers_per_sec=round(n / (t4 - t3)),
               query_file_total_mod256=int(total) & 0xFFFFFFFF,
               stage_query_s=round(t4 - t3, 3),
               e2e_peak_gib=peak_gib(dev))
    return out


def expand_bench(dev: torch.device, rows: int = 1 << 23, k: int = 31,
                 m: int = 11, b: int = 8) -> dict:
    """The span-expansion kernel (csrc/expand_span.cu, J-major) at the
    finalize span of the 50 Mb deployment: its time, its byte bound and
    share of it, and its plain PyTorch version's time
    (bench_expand.measure, which first checks the kernel's output equal to
    the plain version's). The plain version stands where the reference
    reports lax_expand_ms; it is not a yardstick. A CPU run has no kernel
    to time: its time fields are null."""
    from brisk_tpu_torch import bench_expand, kernels
    from brisk_tpu_torch.index import sklstore
    out = dict(expand_rows=rows,
               expand_bound_ms=bench_expand.bound_ms(rows, k, m, b),
               expand_bound_by="bytes", expand_kernel_ms=None,
               expand_share_of_bound=None, expand_plain_ms=None)
    if dev.type != "cuda":
        return out
    kernels.build([sklstore.skl_dims(k, m, b)[1]])
    t = bench_expand.measure("finalize-k31", (k, m, b), rows, "jmajor", dev)
    out.update(expand_kernel_ms=t["kernel_ms"],
               expand_share_of_bound=t["share_of_bound"],
               expand_plain_ms=t["plain_ms"], expand_fill_ms=t["fill_ms"])
    return out


def k63_e2e_bench(dev: torch.device, data_dir: str,
                  n_bases: int = 4_600_000, read_len: int = 10_000,
                  batch: int = 1024, window: int = 512,
                  stack: int = 4) -> dict:
    """k=63 m=21 b=14 warmup -> insert_file -> finalize (the reference's
    own debug configuration) on 10 kb records: the streaming insert."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    path = synth_path(data_dir, n_bases, read_len)
    br = Brisk(Parameters(63, 21, 14), batch=batch, window=window,
               stack=stack, device=dev)
    t = _e2e_run(br, path, dev, dict(record_len_hint=read_len))
    n = br.n_emitted
    warm = t["t2"] - t["t0"]
    return dict(
        k63_e2e_kmers_per_sec=round(n / warm),
        k63_e2e_vs_cpu_ref=round(n / warm / K63_REF_KMERS_PER_S, 2),
        k63_warmup_s=round(t["t0"] - t["cold"], 3),
        k63_insert_s=round(t["t1"] - t["t0"], 3),
        k63_finalize_s=round(t["t2"] - t["t1"], 3),
        k63_nb_kmers=n,
        k63_repaired_windows=br.n_repaired_windows,
        k63_repair_batches=br.n_repair_batches,
    )


def k63_short_read_bench(dev: torch.device, data_dir: str,
                         n_bases: int = 4_600_000, read_len: int = 150,
                         batch: int = 4096, window: int = 512,
                         stack: int = 4) -> dict:
    """k=63 on 150 bp reads, the common real-world input shape: the
    short-read route packs one read per lane."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    path = synth_path(data_dir, n_bases, read_len)
    br = Brisk(Parameters(63, 21, 14), batch=batch, window=window,
               stack=stack, device=dev)
    t = _e2e_run(br, path, dev, dict(record_len_hint=read_len))
    n = br.n_emitted
    return dict(
        k63_shortread_kmers_per_sec=round(n / (t["t2"] - t["t0"])),
        k63_shortread_warmup_s=round(t["t0"] - t["cold"], 3),
        k63_shortread_insert_s=round(t["t1"] - t["t0"], 3),
        k63_shortread_finalize_s=round(t["t2"] - t["t1"], 3),
        k63_shortread_nb_kmers=n,
    )


def scale_500mb_bench(dev: torch.device, data_dir: str,
                      n_bases: int = 500_000_000, read_len: int = 10_000,
                      k: int = 31, m: int = 11, b: int = 8,
                      batch: int = 2048, window: int = 512, stack: int = 8,
                      segment_rows: int = None) -> dict:
    """500 Mb ingest at k=31: the mid-ingest segment finalizes (one every
    `segment_rows` rows, Brisk's default unless given) bound the
    consolidation working set. Segment count, overflows, peak host RSS of
    the process (all stages so far) and the peak device memory of this
    stage."""
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    path = synth_path(data_dir, n_bases, read_len)
    br = Brisk(Parameters(k, m, b), batch=batch, window=window, stack=stack,
               device=dev)
    if segment_rows is not None:
        br.segment_rows = segment_rows
    reset_peak(dev)
    t = _e2e_run(br, path, dev, {})
    n = br.n_emitted
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return dict(
        scale500_kmers_per_sec=round(n / (t["t2"] - t["t0"])),
        scale500_warmup_s=round(t["t0"] - t["cold"], 3),
        scale500_insert_s=round(t["t1"] - t["t0"], 3),
        scale500_finalize_s=round(t["t2"] - t["t1"], 3),
        scale500_nb_kmers=n,
        scale500_segments=len(br._skl_segments),
        scale500_segment_rows=br.segment_rows,
        scale500_rows=int(br.skl.n_rows),
        scale500_skl_overflows=br.n_skl_overflows,
        scale500_repaired_windows=br.n_repaired_windows,
        scale500_host_rss_gb=round(rss_gb, 2),
        scale500_peak_gib=peak_gib(dev),
    )


def sharded_overhead(dev: torch.device, k: int = 31, m: int = 11,
                     b: int = 8, batch: int = 2048, window: int = 512,
                     stack: int = 8, shards=(1, 8), steps: int = 3) -> dict:
    """Per-step cost of the sharded product insert: one ShardedBrisk step
    (the flush of one window stack: enumeration, routing, the exchange,
    append, and the step's host bookkeeping) at each shard count of
    `shards` on the one device, with the same `batch` lanes in all
    (batch_per_shard = batch / n) and the same stacks of one random
    record. Median of `steps` steps after one warm step, each timed with
    a synchronize on both sides. (The reference times its legacy
    per-k-mer sharded insert, which the port does not have.)"""
    from brisk_tpu_torch.index import pipeline
    from brisk_tpu_torch.io import windows
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    packer = windows.WindowPacker(k, m, batch, l_out=window)
    rng = np.random.default_rng(7)
    rec_len = (steps + 1) * stack * batch * packer.useful + packer.l_buf
    rec = rng.integers(0, 4, rec_len, dtype=np.uint8)
    stacks = list(itertools.islice(packer.record_stacks([rec], stack),
                                   steps + 1))
    out = {}
    for n in shards:
        sb = ShardedBrisk(Parameters(k, m, b), n_devices=n,
                          batch_per_shard=batch // n, window=window,
                          stack=stack, device=dev)
        # the state ShardedBrisk._insert_codes sets up for its steps
        sb._prev_tail = None
        sb._chain = pipeline.zero_chain(sb.device)
        times = []
        for i, st in enumerate(stacks):
            sync(dev)
            t0 = time.perf_counter()
            sb._flush_stack(packer, st)
            sync(dev)
            if i:
                times.append(time.perf_counter() - t0)
        out[f"sharded_step_ms_n{n}"] = 1e3 * float(np.median(times))
        out[f"sharded_nb_kmers_n{n}"] = sb.n_emitted
        out[f"sharded_n_spilled_n{n}"] = sb.n_spilled
        out[f"sharded_repaired_windows_n{n}"] = sb.n_repaired_windows
        del sb
    lo, hi = min(shards), max(shards)
    out[f"sharded_overhead_ratio_n{hi}_vs_n{lo}"] = (
        out[f"sharded_step_ms_n{hi}"] / out[f"sharded_step_ms_n{lo}"])
    out["sharded_steps_timed"] = steps
    return out


def run_stage(rec: dict, name: str, fn, *args, **kw) -> dict:
    """Run one stage; a failure is recorded as `<name>_error` (with the
    traceback on stderr), never dropped."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
    except Exception as e:
        traceback.print_exc()
        print(f"[bench] {name} FAILED in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
        rec[f"{name}_error"] = f"{type(e).__name__}: {e}"[:300]
        return {}
    print(f"[bench] {name} done in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    return out


def stage_calls(dev: torch.device, data_dir: str, quick: bool) -> dict:
    """name -> (function, positional args, keyword args) of every stage."""
    with_data = (dev, data_dir)
    calls = dict(product=(product_device_bench, (dev,)),
                 e2e=(e2e_bench, with_data),
                 expand=(expand_bench, (dev,)),
                 k63=(k63_e2e_bench, with_data),
                 k63_short=(k63_short_read_bench, with_data),
                 scale500=(scale_500mb_bench, with_data),
                 sharded=(sharded_overhead, (dev,)))
    return {name: (fn, args, QUICK[name] if quick else {})
            for name, (fn, args) in calls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Benchmark of brisk_tpu_torch's product paths")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true",
                    help="every input ~1/50 of its size")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated subset of " + ",".join(STAGES))
    ap.add_argument("--data-dir", default=None,
                    help="where the synthetic inputs are written once "
                    "(default: the temp directory)")
    a = ap.parse_args(argv)
    stages = [s for s in a.stages.split(",") if s]
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}")
    dev = device_of(a.device)
    data_dir = a.data_dir or os.path.join(tempfile.gettempdir(),
                                          "brisk_bench")
    rec = dict(card_info(dev), device=str(dev), quick=a.quick,
               torch=torch.__version__)
    print(f"{rec['device_name']}, {rec['power_limit_w']}", flush=True)
    calls = stage_calls(dev, data_dir, a.quick)
    for name in stages:
        fn, args, kw = calls[name]
        if name == "product":  # the primary metric: a failure is fatal
            t0 = time.perf_counter()
            rec.update(fn(*args, **kw))
            print(f"[bench] product done in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        else:
            rec.update(run_stage(rec, name, fn, *args, **kw))
    print(json.dumps(rec), flush=True)
    if any(key.endswith("_error") for key in rec):
        return 3  # loud failure; the fields that were measured are printed
    return 0


if __name__ == "__main__":
    sys.exit(main())
