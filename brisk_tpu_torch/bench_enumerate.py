"""Timings of the enumerator's two CUDA kernels on one card, at the shapes
the main path gives them:

    python -m brisk_tpu_torch.bench_enumerate

For each geometry of GEOMETRIES (random codes, seed 1234): the rescan
(kernels.rescan) over the (B, L_buf) batch and the state machine
(kernels.state_scan) over its L_out emitting positions, each held to its
plain PyTorch version on the same inputs (`max_abs_err`, 0 or raise),
with its CUDA-event time (`kernel_ms`), the plain version's
(`plain_ms`), its bound (`bound_ms`, `bound_by`) and the share of it.
The bound is the larger of the bytes it must move (each input read once,
each output written once) over the card's 3.35 TB/s and, for the rescan
past clean_max (k > 32), its float64 additions over the card's float64
rate. No single PyTorch call computes either function (`library_ms`
null). One JSON line per kernel and geometry, after the card's name and
power limit; needs a CUDA card.
"""

import json
import sys

import numpy as np
import torch

from brisk_tpu_torch import bench_expand, kernels

HBM_BYTES_PER_S = bench_expand.HBM_BYTES_PER_S
# H100 SXM float64 outside the tensor cores (NVIDIA's data sheet), 700 W
FP64_OPS_PER_S = 34e12

# (name, (k, m, b), lanes B, emitting positions L_out, windowed): the
# insert's batch at the bench geometry and the k=63 streaming insert's
GEOMETRIES = (
    ("insert-k31", (31, 11, 8), 2048, 512, True),
    ("stream-k63", (63, 21, 14), 1024, 512, False),
)


def rescan_work(R: int, L: int, k_arg: int, m: int, with_unique: bool):
    """(bytes, float64 additions) of one rescan over (R, L): per position
    9 int64 + 1 bool in, 6 int64 + 1 bool (+1 unique) out; per position
    and offset past clean_max two decycling sums of m-1 additions."""
    n = R * L
    bytes_ = n * (9 * 8 + 1 + 6 * 8 + 1 + (1 if with_unique else 0))
    W = k_arg - m + 1
    truncated = max(0, (W - 1) - (64 - 2 * m) // 2)
    return bytes_, n * truncated * 2 * (m - 1)


def state_scan_bytes(B: int, L_out: int) -> int:
    """Per emitting position 11 int64 + 2 bool in, 3 int64 + 2 bool out;
    per lane the 7-field state in and out (6 int64 + 1 bool) and fresh."""
    return B * L_out * (11 * 8 + 2 + 3 * 8 + 2) + B * (2 * 49 + 1)


def bound(bytes_: int, fp64_adds: int = 0) -> dict:
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = fp64_adds / FP64_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=bytes_, fp64_adds=fp64_adds)


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
    kernel, the rescan and the fresh-lane init state (every lane
    fresh)."""
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
    state0 = minimizer.MinimizerState(*(x[:, -1].contiguous()
                                        for x in init))
    fresh = torch.ones(B, dtype=torch.bool, device=dev)
    return pa, state0, fresh


def measure(name: str, kmb, B: int, L_out: int, windowed: bool, dev,
            timed: bool = True) -> list:
    """Both kernels at one geometry against their plain versions (raise
    on any difference); with `timed`, their times and bounds. Returns one
    dict per kernel."""
    from brisk_tpu_torch.ops import enumerate as enum_ops
    from brisk_tpu_torch.ops import minimizer
    k, m, _ = kmb
    margin = k - 1
    with_unique = windowed and k <= 32
    pa, state0, fresh = inputs(kmb, B, L_out, dev)
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
    err = max_abs_err(flat(res), flat(rescan_plain()))
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
        for row, fn, plain in ((rows[0], rescan, rescan_plain),
                               (rows[1], scan, scan_plain)):
            row["kernel_ms"] = bench_expand.time_ms(fn)
            row["plain_ms"] = bench_expand.time_ms(plain, reps=3, calls=1)
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            row["library_ms"] = None
    return rows


def main(argv=None) -> int:
    from brisk_tpu_torch import bench
    dev = bench.device_of("cuda")
    info = bench.card_info(dev)
    print(f"{info['device_name']}, {info['power_limit_w']}", flush=True)
    kernels.build()
    for name, kmb, B, L_out, windowed in GEOMETRIES:
        for row in measure(name, kmb, B, L_out, windowed, dev):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
