"""Span-expansion kernel timings on one CUDA card, at the shapes the main
path gives the kernel:

    python -m brisk_tpu_torch.bench_expand

For each shape of SHAPES: the kernel's CUDA-event time in the shape's
layout (`kernel_ms`), its bound (`bound_ms`: each input read once and
each output written once, over the card's 3.35 TB/s; the bit arithmetic
has no tensor-core or floating-point rate to be bound by), the share of
that bound, the time of `fill_` over a tensor of the output's shape
(`fill_ms`: how fast the card writes that many bytes), the plain PyTorch
version's time and, for the row-major shapes, the old row-major path
(`old_path_ms`: the J-major kernel, then a transpose). One JSON line per
shape, after the card's name and power limit and the ptxas register
report; needs a CUDA card.
"""

import json
import subprocess
import sys

import numpy as np
import torch

from brisk_tpu_torch import kernels
from brisk_tpu_torch.index import sklstore, store

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak at 700 W

# (name, (k, m, b), rows R, layout): the span shapes of the main path
SHAPES = (
    ("finalize-k31-50Mb", (31, 11, 8), 1 << 23, "jmajor"),
    ("consolidate-k31-2x50Mb", (31, 11, 8), 1 << 24, "rowmajor"),
    ("finalize-k63-4.6Mb", (63, 21, 14), 786_432, "jmajor"),
    ("expand-device-k31-50Mb", (31, 11, 8), 1 << 23, "rowmajor"),
)


def span_rows(R: int, k: int, m: int, b: int, seed: int, device,
              garbage: float = 0.0):
    """Random span rows (int32 columns on `device`) shaped like the rows
    the insert writes: bucket < 4^b or dead (15%), size in [1, s_max],
    mini - (size-1) in [suffix_reduc, cs - (size-1)], so every live row
    is regular for the kernel. `garbage`: the share of rows whose meta
    is any u32 instead (1.0: all; the kernel must still match its plain
    version bit for bit). Returns (bucket, meta, nucs, s_max)."""
    cs, s_max, _, nw = sklstore.skl_dims(k, m, b)
    low = (m - b + 1) // 2
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, 1 << (2 * b), R, dtype=np.uint32)
    bucket[rng.random(R) < 0.15] = 0xFFFFFFFF
    size = rng.integers(1, s_max + 1, R, dtype=np.int64)
    top = np.maximum(cs - (size - 1), low)
    mini = (size - 1) + low + (rng.random(R) * (top - low + 1)).astype(
        np.int64)
    mini = np.minimum(mini, np.maximum(cs, size - 1))
    meta = (size | (mini << 8)).astype(np.uint32)
    junk = rng.integers(0, 1 << 32, R, dtype=np.uint32)
    meta = np.where(rng.random(R) < garbage, junk, meta).astype(np.uint32)
    nucs = rng.integers(0, 1 << 32, (nw, R), dtype=np.uint32)

    def dev(a):
        return torch.from_numpy(a.view(np.int32).copy()).to(device)

    return dev(bucket), dev(meta), dev(nucs), s_max


def time_ms(fn, reps: int = 5, calls: int = 10) -> float:
    """Time of one fn() on the card: the median over `reps` of the
    CUDA-event time of `calls` back-to-back calls, divided by `calls`,
    after a warm call. Back to back, the host's time to enqueue a call
    (the wrapper's checks, the output's allocation, the launch) overlaps
    the previous call's device time instead of being counted."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return sorted(times)[len(times) // 2]


def span_bytes(R: int, k: int, m: int, b: int) -> int:
    """Bytes the expansion must move: bucket, meta and the nucleotide
    words read once, W * s_max key words per row written once."""
    _, s_max, _, nw = sklstore.skl_dims(k, m, b)
    return 4 * R * (2 + nw + store.key_words(k, b) * s_max)


def bound_ms(R: int, k: int, m: int, b: int) -> float:
    return span_bytes(R, k, m, b) / HBM_BYTES_PER_S * 1e3


def plain(layout: str):
    """The plain PyTorch version of the span expansion in `layout`."""
    if layout == "jmajor":
        return sklstore._expand_span_jmajor_torch
    return sklstore._expand_span_rowmajor_torch


def measure(name, kmb, R: int, layout: str, dev, reps: int = 10) -> dict:
    """Times of one shape (see the module note); the kernel's output is
    first checked equal to the plain version's."""
    k, m, b = kmb
    sb, sm, sn, s_max = span_rows(R, k, m, b, seed=R + k, device=dev)
    args = (sb, sm, sn, k, m, b, s_max)
    out = dict(shape=name, k=k, m=m, b=b, R=R, layout=layout,
               bytes=span_bytes(R, k, m, b), bound_ms=bound_ms(R, k, m, b),
               bound_by="bytes")

    def kern():
        return kernels.expand_span(*args, layout=layout)

    if not torch.equal(kern(), plain(layout)(*args)):
        raise RuntimeError(f"kernel output != plain version at {name}")
    torch.cuda.empty_cache()
    out["kernel_ms"] = time_ms(kern, reps)
    out["share_of_bound"] = out["bound_ms"] / out["kernel_ms"]
    if layout == "rowmajor":
        out["old_path_ms"] = time_ms(lambda: sklstore._jmajor_to_rowmajor(
            kernels.expand_span(*args, layout="jmajor"), s_max), reps)
    W = store.key_words(k, b)
    fill = torch.empty((W, s_max * R), dtype=torch.int32, device=dev)
    out["fill_ms"] = time_ms(lambda: fill.fill_(-1), reps)
    del fill
    out["plain_ms"] = time_ms(lambda: plain(layout)(*args), 3, calls=1)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_expand needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "torch": torch.__version__}), flush=True)
    s_maxes = sorted({sklstore.skl_dims(*kmb)[1] for _, kmb, _, _ in SHAPES})
    for name, log in kernels.build(s_maxes).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(json.dumps({"build": name, "ptxas": line.strip()}))
    for name, kmb, R, layout in SHAPES:
        print(json.dumps(measure(name, kmb, R, layout, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
