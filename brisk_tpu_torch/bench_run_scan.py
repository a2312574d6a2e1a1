"""Timings of the run scan's two CUDA kernels (csrc/run_scan.cu) on one
card, at the shapes the main path gives them:

    python -m brisk_tpu_torch.bench_run_scan

For each shape of SHAPES, on inputs made on the card from a seed (sorted
runs of 1..max_run slots, their mean length (max_run + 1) / 2, one run
when max_run >= slots; the join's
index counts anywhere in [0, 2^32), half of them below 300, its query
liveness 0, 1 or 2; compact's counts in [0, 2^32), 30% of them 0): the
kernel (kernels.join_scan or kernels.run_totals) held to its plain
PyTorch version (sklstore._join_scan_torch, store._run_totals_torch) on
the same inputs (`max_abs_err`, 0 or raise), its CUDA-event time
(`kernel_ms`, bench_expand.time_ms), the plain version's (`plain_ms`),
the time of the one PyTorch call pair that computes the scan's core,
torch.cumsum then torch.cummax of the payload (`library_ms`; the port
never calls it), and its bound (`bound_ms`: each input read once and
each output written once over the card's 3.35 TB/s; a few integer
operations a slot have no rate to be bound by). One JSON line per shape,
after the card's name and power limit; needs a CUDA card.
"""

import json
import sys

import torch

from brisk_tpu_torch import bench, bench_expand, kernels
from brisk_tpu_torch.index import sklstore, store

HBM_BYTES_PER_S = bench_expand.HBM_BYTES_PER_S
M32 = 0xFFFFFFFF

# (name, kernel, slots, key words W, longest run): the query joins'
# shapes on the main path (the slots each join scans, as chip_smoke.py
# records them on the card: the 50 Mb deployment's query_file, index
# expansion and query chunk; one shard's of the 8-shard facade's; the
# k=63 4.6 Mb query_file) and reallocate's two compactions at k=63 (the
# rekeyed entries, then compact_auto's power-of-two prefix)
SHAPES = (
    ("join-deploy-k31-50Mb", "join_scan", 1 << 27, 3, 5),
    ("join-sharded-k31-50Mb-shard", "join_scan", 75_497_472, 3, 5),
    ("join-k63-4.6Mb", "join_scan", 12_582_912, 6, 5),
    ("compact-rekey-k63", "run_totals", 6_291_456, 1, 3),
    ("compact-rekey-k63-prefix", "run_totals", 1 << 23, 1, 3),
)


def inputs(kernel: str, n: int, W: int, max_run: int, dev,
           seed: int = 1234) -> tuple:
    """The kernel's inputs on `dev`: (words (W, n) int64, pay (n,) int64)
    for join_scan, (data (n,) int64, first (n,) bool) for run_totals. A
    slot starts a run with probability 2 / (max_run + 1), or only slot 0
    does when max_run >= n; the join's side tags are random within a
    key."""
    g = torch.Generator(device=dev).manual_seed(seed)
    first = torch.rand(n, generator=g, device=dev) < 2 / (max_run + 1)
    if max_run >= n:
        first.zero_()
    first[0] = True
    big = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
    small = torch.rand(n, generator=g, device=dev) < 0.5
    if kernel == "run_totals":
        return torch.where(torch.rand(n, generator=g, device=dev) < 0.3, 0,
                           big), first
    key = torch.cumsum(first, 0)
    tag = (torch.rand(n, generator=g, device=dev) < 0.4).to(torch.int64)
    words = torch.zeros((W, n), dtype=torch.int64, device=dev)
    words[W - 1] = ((key << 1) & M32) | tag
    if W > 1:
        words[W - 2] = key >> 31
    pay = torch.where(small, big % 300, big)
    return words, torch.where(tag == 1, pay % 3, pay)


def plain(kernel: str):
    return (sklstore._join_scan_torch if kernel == "join_scan"
            else store._run_totals_torch)


def wrapper(kernel: str):
    return getattr(kernels, kernel)


def library_call(kernel: str, args: tuple):
    """The PyTorch call pair at the scan's core on the same payload: an
    int64 cumsum and a cummax with indices (what the plain versions spend
    their time in)."""
    x = args[1] if kernel == "join_scan" else args[0]
    return lambda: (torch.cumsum(x, 0), torch.cummax(x, 0))


def bytes_moved(kernel: str, n: int, W: int) -> int:
    """join_scan: W int64 words and the int64 payload a slot in, 256 int64
    out; run_totals: the int64 count and the bool flag a slot in, two
    int64 out."""
    if kernel == "join_scan":
        return 8 * (W + 1) * n + 8 * 256
    return 9 * n + 16 * n


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise RuntimeError(f"kernel output {g.dtype} {tuple(g.shape)} "
                               f"!= plain {w.dtype} {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g - w).abs().max()))
        if not torch.equal(g, w):  # a difference of -2^63 has no abs
            err = max(err, 1)
    return err


def measure(name: str, kernel: str, n: int, W: int, max_run: int, dev,
            timed: bool = True, repeats: int = 1) -> dict:
    """One shape: the kernel, called `repeats` times, against its plain
    version (raise unless every call is exact) and, when `timed`, the
    times of the kernel, the plain version and the library call pair, and
    the bound."""
    args = inputs(kernel, n, W, max_run, dev, seed=n + W)
    want = plain(kernel)(*args)
    err = 0
    for _ in range(repeats):
        got = wrapper(kernel)(*args)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        del got
    if err:
        raise RuntimeError(f"{kernel} != its plain version at {name}: "
                           f"max_abs_err {err}")
    del want
    row = dict(kernel=kernel, shape=name, n=n, W=W, max_run=max_run,
               repeats=repeats, max_abs_err=err)
    if timed:
        bound_ms = bytes_moved(kernel, n, W) / HBM_BYTES_PER_S * 1e3
        kernel_ms = bench_expand.time_ms(lambda: wrapper(kernel)(*args))
        row.update(
            kernel_ms=kernel_ms,
            plain_ms=bench_expand.time_ms(lambda: plain(kernel)(*args),
                                          reps=3, calls=1),
            library_ms=bench_expand.time_ms(library_call(kernel, args),
                                            reps=3, calls=1),
            bound_ms=bound_ms, bound_by="bytes",
            bytes=bytes_moved(kernel, n, W),
            share_of_bound=bound_ms / kernel_ms)
    del args
    torch.cuda.empty_cache()
    return row


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_run_scan needs a CUDA card")
    dev = torch.device("cuda", 0)
    info = bench.card_info(dev)
    print(f"{info['device_name']}, {info['power_limit_w']}", flush=True)
    for line in kernels.build().get("run_scan", "").splitlines():
        if "registers" in line or "spill" in line:
            print(json.dumps({"build": "run_scan", "ptxas": line.strip()}))
    for shape in SHAPES:
        print(json.dumps(measure(*shape, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
