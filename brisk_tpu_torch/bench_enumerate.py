"""Timings of the enumerator's two CUDA kernels on one card, at the shapes
the main path gives them:

    python -m brisk_tpu_torch.bench_enumerate [--against DIR ...]

For each geometry of GEOMETRIES (random codes, seed 1234): the rescan
(kernels.rescan) over the (B, L_buf) batch and the state machine
(kernels.state_scan) over its L_out emitting positions, each held to its
plain PyTorch version on the same inputs (`max_abs_err`, 0 or raise; the
rescan also over the fresh-lane init's (B, k-1) rows), with its device
time (`device_ms`: calls replayed from a CUDA graph, free of the host's
work), the CUDA-event time per call of back-to-back calls (`kernel_ms`:
what a caller waits for, the wrapper's host work included where it
takes longer than the kernel), the plain version's (`plain_ms`), its
bound (`bound_ms`, `bound_by`) and the share of it (`share_of_bound`,
of `device_ms`). The bound is the larger of the bytes it must move
(each input read once, each output written once) over the card's
3.35 TB/s and, for the rescan past clean_max (k > 32), the float64
additions that these inputs need over the card's float64 addition
rate. No single PyTorch call computes
either function (`library_ms` null). One JSON line per kernel and
geometry, after the card's name and power limit; needs a CUDA card.

`--against DIR` (repeatable) also builds the two kernels from another
checkout's sources (DIR is its `brisk_tpu_torch/csrc`, e.g. a parent
commit unpacked with `git archive` into a gitignored directory; the C
entries must be this tree's) and times them in turns with this tree's
(other, this, this, other), by device time: `against` lists each DIR's
two times and its `max_abs_err` to the plain version, `device_ms_turns`
this tree's two.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from brisk_tpu_torch import bench_expand, kernels

HBM_BYTES_PER_S = bench_expand.HBM_BYTES_PER_S
# H100 SXM float64 additions outside the tensor cores at 700 W: the data
# sheet's 34 TFLOP/s counts an FMA as two operations, so a chain of
# additions alone reaches half of it
FP64_ADDS_PER_S = 17e12
NAMES = ("state_scan", "rescan")

# (name, (k, m, b), lanes B, emitting positions L_out, windowed): the
# insert's batch at the bench geometry and the k=63 streaming insert's
GEOMETRIES = (
    ("insert-k31", (31, 11, 8), 2048, 512, True),
    ("stream-k63", (63, 21, 14), 1024, 512, False),
)


def rescan_work(R: int, L: int, k_arg: int, m: int, with_unique: bool):
    """(bytes, float64 additions) of one rescan over (R, L): per position
    9 int64 + 1 bool in, 6 int64 + 1 bool (+1 unique) out; two decycling
    sums of m-1 additions per position for each truncated offset
    clean_max < i < 32, and once per call for the offsets i >= 32, whose
    m-mer is 0 at every position (one constant candidate)."""
    n = R * L
    bytes_ = n * (9 * 8 + 1 + 6 * 8 + 1 + (1 if with_unique else 0))
    W = k_arg - m + 1
    clean_max = (64 - 2 * m) // 2
    varying = max(0, min(W - 1, 31) - clean_max)
    constant = W - 1 >= 32 and W - 1 > clean_max
    return bytes_, (n * varying + constant) * 2 * (m - 1)


def state_scan_bytes(B: int, L_out: int) -> int:
    """Per emitting position 11 int64 + 2 bool in, 3 int64 + 2 bool out;
    per lane the 7-field state in and out (6 int64 + 1 bool) and fresh."""
    return B * L_out * (11 * 8 + 2 + 3 * 8 + 2) + B * (2 * 49 + 1)


def bound(bytes_: int, fp64_adds: int = 0) -> dict:
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = fp64_adds / FP64_ADDS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=bytes_, fp64_adds=fp64_adds)


@contextlib.contextmanager
def kernels_from(csrc: str):
    """Inside the block, kernels.state_scan and kernels.rescan launch the
    kernels built from the sources in `csrc` (another checkout's, with
    the same C entries)."""
    saved = {name: kernels._SOURCES[name] for name in NAMES}
    for name in NAMES:
        kernels._SOURCES[name] = saved[name]._replace(
            path=os.path.join(os.path.abspath(csrc), name + ".cu"))
    try:
        yield
    finally:
        kernels._SOURCES.update(saved)


def max_abs_err(got, want) -> int:
    """Largest |difference| over paired tensors (bool and int64)."""
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise RuntimeError(f"kernel output {g.dtype} {tuple(g.shape)} "
                               f"!= plain {w.dtype} {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def inputs(kmb, B: int, L_out: int, dev, seed: int = 1234):
    """Random codes of B lanes, their position arrays and, from the
    kernel, the fresh-lane init state (every lane fresh); also the init's
    max_abs_err: its rescan over the (B, k-1) rows against the plain
    version's."""
    from brisk_tpu_torch.ops import minimizer
    k, m, _ = kmb
    margin = k - 1
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 4, (B, margin + L_out),
                                          dtype=np.uint8)).to(dev)
    codes = codes.to(torch.int64)
    pa = minimizer.position_pipeline(codes, k, m)
    pa_init = minimizer.position_pipeline(codes[:, :margin], k - 1, m)
    init = minimizer.windowed_get_minimizer(pa_init, pa_init.fwd_k, k - 1,
                                            m)
    init_err = max_abs_err(init, minimizer.windowed_get_minimizer_torch(
        pa_init, pa_init.fwd_k, k - 1, m))
    state0 = minimizer.MinimizerState(*(x[:, -1].contiguous()
                                        for x in init))
    fresh = torch.ones(B, dtype=torch.bool, device=dev)
    return pa, state0, fresh, init_err


def device_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """The device time of one fn(): `calls` calls captured in one CUDA
    graph, the median over `reps` replays of its CUDA-event time, divided
    by `calls`. A replay launches the kernels back to back with none of
    the host's work (the wrappers' checks and allocations take longer
    than these kernels run), so this is the kernels' own time plus the
    graph's gap between launches (~1 µs)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    del graph
    torch.cuda.empty_cache()
    return sorted(times)[len(times) // 2]


def time_turns(fn, against: tuple) -> dict:
    """The kernel's device time (device_ms) with this tree's kernels and,
    for each csrc of `against`, with that tree's, in turns (other, this,
    this, other): `device_ms_turns` and `against` [{csrc, device_ms:
    [first, last]}]."""
    this, other = [], []
    for csrc in against:
        with kernels_from(csrc):
            first = device_ms(fn)
        this += [device_ms(fn), device_ms(fn)]
        with kernels_from(csrc):
            other.append(dict(csrc=csrc, device_ms=[first, device_ms(fn)]))
    return dict(device_ms_turns=this, against=other)


def measure(name: str, kmb, B: int, L_out: int, windowed: bool, dev,
            timed: bool = True, against: tuple = ()) -> list:
    """Both kernels at one geometry against their plain versions (raise
    on any difference); with `timed`, their times and bounds, and each
    `against` tree's in turns with this tree's (time_turns). Returns one
    dict per kernel."""
    from brisk_tpu_torch.ops import enumerate as enum_ops
    from brisk_tpu_torch.ops import minimizer
    k, m, _ = kmb
    margin = k - 1
    with_unique = windowed and k <= 32
    pa, state0, fresh, init_err = inputs(kmb, B, L_out, dev)
    L_buf = margin + L_out

    def rescan():
        return minimizer.windowed_get_minimizer(pa, pa.fwd_k, k, m,
                                                with_unique)

    def rescan_plain():
        return minimizer.windowed_get_minimizer_torch(pa, pa.fwd_k, k, m,
                                                      with_unique)

    def flat(out):
        return list(out[0]) + [out[1]] if with_unique else list(out)

    res = rescan()
    err = max(init_err, max_abs_err(flat(res), flat(rescan_plain())))
    res_state = res[0] if with_unique else res

    def scan():
        return enum_ops._state_machine(state0, pa, res_state, fresh, k - m,
                                       margin)

    def scan_plain():
        return enum_ops._state_machine_torch(state0, pa, res_state, fresh,
                                             k - m, margin)

    def flat_scan(out):
        return list(out[0]) + list(out[1])

    scan_err = max_abs_err(flat_scan(scan()), flat_scan(scan_plain()))
    torch.cuda.synchronize()
    if err or scan_err:
        raise RuntimeError(f"{name}: kernel != plain version (rescan "
                           f"max_abs_err {err}, state_scan {scan_err})")
    rows = [dict(kernel="rescan", geometry=name, k=k, m=m, R=B, L=L_buf,
                 max_abs_err=err,
                 **bound(*rescan_work(B, L_buf, k, m, with_unique))),
            dict(kernel="state_scan", geometry=name, k=k, m=m, B=B,
                 L_out=L_out, max_abs_err=scan_err,
                 **bound(state_scan_bytes(B, L_out)))]
    if timed:
        for row, fn, plain, flat_fn in (
                (rows[0], rescan, rescan_plain, flat),
                (rows[1], scan, scan_plain, flat_scan)):
            row["device_ms"] = device_ms(fn)
            row["kernel_ms"] = bench_expand.time_ms(fn)
            row["plain_ms"] = bench_expand.time_ms(plain, reps=3, calls=1)
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            row["library_ms"] = None
            if against:
                row.update(time_turns(fn, against))
                want = flat_fn(plain())
                for other in row["against"]:
                    with kernels_from(other["csrc"]):
                        other["max_abs_err"] = max_abs_err(flat_fn(fn()),
                                                           want)
    return rows


def measure_rows(name: str, k_arg: int, m: int, R: int, L: int, dev,
                 seed: int = 1234) -> dict:
    """The rescan alone over (R, L) rows of random codes (the rows of
    rekey._rekey_batch at L = k, of a fresh-lane init at L = k-1) against
    its plain version; raise on any difference."""
    from brisk_tpu_torch.ops import minimizer
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 4, (R, L))).to(dev)
    pa = minimizer.position_pipeline(codes, k_arg, m)
    err = max_abs_err(
        minimizer.windowed_get_minimizer(pa, pa.fwd_k, k_arg, m),
        minimizer.windowed_get_minimizer_torch(pa, pa.fwd_k, k_arg, m))
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"{name}: rescan != plain version (max_abs_err "
                           f"{err})")
    return dict(kernel="rescan", geometry=name, k=k_arg, m=m, R=R, L=L,
                max_abs_err=err)


def main(argv=None) -> int:
    from brisk_tpu_torch import bench
    ap = argparse.ArgumentParser(prog="python -m brisk_tpu_torch."
                                 "bench_enumerate")
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout's brisk_tpu_torch/csrc whose "
                    "kernels to time in turns with this tree's")
    args = ap.parse_args(argv)
    dev = bench.device_of("cuda")
    info = bench.card_info(dev)
    print(f"{info['device_name']}, {info['power_limit_w']}", flush=True)
    kernels.build()
    for name, kmb, B, L_out, windowed in GEOMETRIES:
        for row in measure(name, kmb, B, L_out, windowed, dev,
                           against=tuple(args.against)):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
