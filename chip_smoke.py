#!/usr/bin/env python3
"""Smoke run of brisk_tpu_torch on one CUDA card: the quickest proof that
the port builds, agrees with its references and serves end to end.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises, so the exit code is
non-zero and no final `ok` line is printed):

1. the card's name and power limit; build every CUDA kernel.
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at the shapes the main path gives it; times at the full shape.
3. fixture parity on the card: counts_dict() equals the pure-Python
   oracle (pyref.count_fasta) on data/test.fa, data/debug_test.fa and a
   fixture that exercises the exact repair and overflow paths.
4. the deployment: k=31 m=11 b=8 counter on a 50 Mb synthetic genome
   (5,000 records of 10 kb, tests/make_synth_fasta.write_synth, seed
   1234) through warmup -> insert_file -> finalize, then stats, point
   lookups and query_file, checked against the reference's totals.

The second-to-last line is the kernel report (JSON), the last line
`{"ok": true, "device": {...}}`. Needs one CUDA card; there is no CPU
fallback.
"""

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


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


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


def span_rows(R: int, k: int, m: int, b: int, seed: int, device):
    """Random span rows that respect the arena's invariants (tests use
    the same recipe): bucket < 4^b or dead, size in [1, s_max]."""
    import numpy as np
    import torch
    from brisk_tpu_torch.index import sklstore
    cs, s_max, _, nw = sklstore.skl_dims(k, m, b)
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, 1 << (2 * b), R, dtype=np.uint32)
    bucket[rng.random(R) < 0.15] = 0xFFFFFFFF
    size = rng.integers(1, s_max + 1, R, dtype=np.uint32)
    mini = (size - 1) + rng.integers(0, cs - s_max + 1, R,
                                     dtype=np.uint32) + 3
    meta = ((size & 0xFF) | ((mini & 0xFF) << 8)).astype(np.uint32)
    nucs = rng.integers(0, 1 << 32, (nw, R), dtype=np.uint32)

    def dev(a):
        return torch.from_numpy(a.view(np.int32).copy()).to(device)

    return dev(bucket), dev(meta), dev(nucs), s_max


def time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() over `reps` runs after a warm run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2]


def phase_kernels(dev) -> dict:
    import torch
    from brisk_tpu_torch import kernels
    from brisk_tpu_torch.index import sklstore
    worst = 0
    for (k, m, b), Rs in (((31, 11, 8), (1024, 12288, 1 << 23)),
                          ((63, 21, 14), (1024, 12288))):
        for R in Rs:
            sb, sm, sn, s_max = span_rows(R, k, m, b, seed=R + k, device=dev)
            got = kernels.expand_span_jmajor(sb, sm, sn, k, m, b, s_max)
            want = sklstore._expand_span_jmajor_torch(sb, sm, sn, k, m, b,
                                                      s_max)
            torch.cuda.synchronize()
            err = int(((got.to(torch.int64) & 0xFFFFFFFF)
                       - (want.to(torch.int64) & 0xFFFFFFFF)).abs().max())
            check(torch.equal(got, want), f"kernel != plain at k={k} R={R}")
            worst = max(worst, err)
            say("kernel", k=k, R=R, exact=True, max_abs_err=err)
            if R == 1 << 23:
                ms = time_ms(lambda: kernels.expand_span_jmajor(
                    sb, sm, sn, k, m, b, s_max))
                plain_ms = time_ms(lambda: sklstore._expand_span_jmajor_torch(
                    sb, sm, sn, k, m, b, s_max))
                say("kernel-time", k=k, R=R, kernel_ms=ms, plain_ms=plain_ms)
            del sb, sm, sn, got, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


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


def phase_deployment(dev, tmp: str) -> dict:
    import torch
    from brisk_tpu_torch import kernels
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.oracle import pyref
    from brisk_tpu_torch.ops import enumerate as enum_ops
    from brisk_tpu_torch.params import Parameters
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from make_synth_fasta import write_synth

    path = os.path.join(tmp, "synth50m.fa")
    t = time.perf_counter()
    write_synth(path, SYNTH_BASES, read_len=SYNTH_READ, seed=SYNTH_SEED)
    say("deploy-input", bases=SYNTH_BASES, records=SYNTH_BASES // SYNTH_READ,
        write_s=round(time.perf_counter() - t, 2))

    idx = Brisk(Parameters(K, M, B), batch=2048, window=512, stack=8,
                device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    # the per-position loop's share of insert: a synchronized host clock
    # around every call of the enumerator's state machine
    loop = {"s": 0.0}
    state_machine = enum_ops._state_machine

    def timed_state_machine(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = state_machine(*args)
        torch.cuda.synchronize()
        loop["s"] += time.perf_counter() - t
        return out

    enum_ops._state_machine = timed_state_machine
    t0 = time.perf_counter()
    idx.warmup(path=path)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    idx.insert_file(path)
    idx._drain()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    enum_ops._state_machine = state_machine
    loop_s = loop["s"]
    launches_before = dict(kernels.LAUNCHES)
    idx.finalize()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    fin_launches = (kernels.LAUNCHES["expand_span_jmajor"]
                    - launches_before["expand_span_jmajor"])
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
        check(getattr(idx.skl, name).device.type == "cuda",
              f"arena column {name} not on the card")

    t = time.perf_counter()
    st = idx.stats()
    say("deploy-stats", stats_s=round(time.perf_counter() - t, 3),
        **{k: v for k, v in st.items()})

    # point lookups: 10,000 k-mers sampled from the input, both strands
    # (Brisk.get_canonical, batched)
    sample = sample_kmers(path, 10_000)
    t = time.perf_counter()
    got = idx.get_many(sample)
    miss = [i for i, c in enumerate(got) if c is None]
    rcs = [pyref.num2str(pyref.revcomp(pyref.str2num(sample[i]), K), K)
           for i in miss]
    for i, c in zip(miss, idx.get_many(rcs)):
        got[i] = c
    get_s = time.perf_counter() - t
    for s, c in zip(sample[:20], got[:20]):
        check(idx.get_canonical(s) == c, "get_canonical != batched lookup")
    hits = sum(1 for c in got if c is not None and c >= 1)
    say("deploy-get", sampled=len(sample), found=hits, get_s=get_s)
    check(hits >= 0.95 * len(sample), f"only {hits} of 10000 found")

    t = time.perf_counter()
    total = idx.query_file(path)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t
    say("deploy-query", query_s=query_s, total=total,
        total_mod32=total & 0xFFFFFFFF, kmers_per_s=EXPECT_KMERS / query_s)
    check(total & 0xFFFFFFFF == EXPECT_KMERS,
          f"query_file total {total} != {EXPECT_KMERS}")
    launches = kernels.LAUNCHES["expand_span_jmajor"]
    check(launches > 0, "the main path never launched the kernel")
    say("deploy-memory",
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return dict(launches=launches)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, REPO)
    from brisk_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    say("device", name=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda)
    t = time.perf_counter()
    logs = kernels.build()
    say("build", seconds=round(time.perf_counter() - t, 2))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", kernel=name, ptxas=line.strip())

    kern = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_fixtures(dev, tmp)
        dep = phase_deployment(dev, tmp)

    report = {"kernels": [{
        "name": "expand_span_jmajor", "route": "cuda",
        "source": "brisk_tpu_torch/csrc/expand_span.cu",
        "replaces": "brisk_tpu/index/sklstore.py:725",
        "launches": dep["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
