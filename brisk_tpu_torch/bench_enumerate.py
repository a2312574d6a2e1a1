"""Timings of the enumerator's five CUDA kernels on one card, at the shapes
the main path gives them:

    python -m brisk_tpu_torch.bench_enumerate [--against DIR ...]

For each geometry of GEOMETRIES (random codes, seed 1234): the position
pipeline (kernels.positions) over the (B, L_buf) batch (checked also
over the fresh-lane init's strided (B, k-1) rows), the rescan
(kernels.rescan) over the batch, the state machine (kernels.state_scan)
over its L_out emitting positions, the emission epilogue (kernels.emit)
over the same positions and the row assembly (kernels.skl_rows) over
their emissions (ragged valid spans, the insert's row_cap), each held
to its plain PyTorch version on the same inputs (`max_abs_err`, 0 or
raise; the rescan also over the fresh-lane init's (B, k-1) rows), with
its device
time (`device_ms`: calls replayed from a CUDA graph, free of the host's
work), the CUDA-event time per call of back-to-back calls (`kernel_ms`:
what a caller waits for, the wrapper's host work included where it
takes longer than the kernel), the plain version's (`plain_ms`), its
bound (`bound_ms`, `bound_by`) and the share of it (`share_of_bound`,
of `device_ms`). The bound is the larger of the bytes it must move
(each input it needs read once, each output written once: the epilogue
needs one orientation's k-mer limbs, the row assembly what this batch's
rows need, skl_rows_bytes) over the card's 3.35 TB/s and the float64 additions that these inputs need (the
rescan's past clean_max at k > 32, the position pipeline's decycling
sums) over the card's float64 addition rate. No single PyTorch call
computes any of these functions (`library_ms` null). One JSON line per
kernel and geometry, after the card's name and power limit; needs a
CUDA card. Last, the position pipeline alone over reallocate's rekey
rows (REKEY_ROWS), timed the same way.

`--against DIR` (repeatable) also builds each of the five kernels whose
source another checkout holds (DIR is its `brisk_tpu_torch/csrc`, e.g. a
parent commit unpacked with `git archive` into a gitignored directory;
the C entries must be this tree's) and times them in turns with this
tree's (other, this, this, other), by device time: `against` lists each
DIR's two times and its `max_abs_err` to the plain version,
`device_ms_turns` this tree's two.
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
NAMES = ("positions", "rescan", "state_scan", "emit", "skl_rows")

# (name, (k, m, b), lanes B, emitting positions L_out, windowed): the
# insert's batch at the bench geometry and the k=63 streaming insert's
GEOMETRIES = (
    ("insert-k31", (31, 11, 8), 2048, 512, True),
    ("stream-k63", (63, 21, 14), 1024, 512, False),
)
# (name, k, m, R, L): reallocate's rekey rows at k=63 (rekey._rekey_batch
# runs the position pipeline over 65,536 rows of one k-mer each, m = 23)
REKEY_ROWS = ("rekey-k63-m23", 63, 23, 65536, 63)


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


def positions_work(R: int, L: int, m: int):
    """(bytes, float64 additions) of one position pipeline over (R, L):
    per position one int64 code in, 17 int64 and 2 bool out; two
    decycling sums of m-1 additions."""
    n = R * L
    return n * (8 + 17 * 8 + 2), n * 2 * (m - 1)


def emit_bytes(B: int, L_out: int) -> int:
    """Per emitting position 3 int64 and 1 bool of the state machine and
    the 4 int64 limbs of the k-mer's emitted orientation (rev selects
    fwd_k or rc_k) in, 14 int64 out."""
    return B * L_out * (7 * 8 + 1 + 14 * 8)


def skl_rows_bytes(valid: torch.Tensor, first_valid: torch.Tensor,
                   boundary: torch.Tensor, k: int, m: int, b: int,
                   row_cap: int) -> int:
    """What the row assembly must move on these (B, L) inputs: valid,
    first_valid and boundary at every position (the scans); mini_idx and
    use_rc at every valid position (its contribution) and at every other
    position that fills a slot (its meta); one key limb at a valid
    position (the one base it adds to its row) and all 4 at a row's
    first (its whole compacted k-mer); the bucket at a kept start; per
    lane out_w = min(L, row_cap) slots of 2 + nw int64 and the overflow
    bool out. The row starts and slots follow the plain version
    (sklstore.rows_from_emissions_torch)."""
    from brisk_tpu_torch.index import sklstore
    _, s_max, _, nw = sklstore.skl_dims(k, m, b)
    B, L = valid.shape
    pos = torch.arange(L, device=valid.device).expand(B, L)
    start = valid & (boundary | first_valid)
    if 2 * (k - m) + 1 > s_max:
        first0 = torch.cummax(torch.where(start, pos, 0), 1).values
        start = start | (valid & (((pos - first0) & (s_max - 1)) == 0))
    keep = start & (start.sum(1, keepdim=True) <= row_cap)
    kept = torch.cumsum(keep, 1)
    out_w = min(L, row_cap)
    # a kept start's slot is its rank; every other position follows them
    # in position order
    slot = torch.where(keep, kept - 1, kept[:, -1:] + pos - kept)
    meta_only = int((~valid & (slot < out_w)).sum())
    return (3 * B * L + 17 * int(valid.sum()) + 9 * meta_only
            + 24 * int(start.sum()) + 8 * int(keep.sum())
            + B * (out_w * (2 + nw) * 8 + 1))


def row_cap_of(L_out: int, windowed: bool) -> int:
    """The insert's row_cap: max(16, window // 4) for the k <= 32
    windowed insert (api.Brisk.skl_row_cap), the full width for the
    streaming insert."""
    return max(16, L_out // 4) if windowed else L_out


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


def has_source(csrc: str, name: str) -> bool:
    """Whether the directory `csrc` holds kernel `name`'s source."""
    return os.path.exists(os.path.join(csrc, name + ".cu"))


@contextlib.contextmanager
def kernels_from(csrc: str):
    """Inside the block, the wrappers of the kernels of NAMES whose
    sources `csrc` holds (another checkout's, with the same C entries)
    launch the kernels built from them."""
    saved = {name: kernels._SOURCES[name] for name in NAMES
             if has_source(csrc, name)}
    for name in saved:
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


def flat_positions(pa) -> list:
    """A PositionArrays' tensors in order."""
    return [t for f in pa for t in (f if isinstance(f, tuple) else (f,))]


def inputs(kmb, B: int, L_out: int, dev, seed: int = 1234):
    """Random codes of B lanes, their position arrays and, from the
    kernels, the fresh-lane init state (every lane fresh); also the
    init's max_abs_err: its position pipeline and rescan over the
    strided (B, k-1) rows against the plain versions'."""
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
    init_err = max(
        max_abs_err(flat_positions(pa_init), flat_positions(
            minimizer.position_pipeline_torch(codes[:, :margin], k - 1,
                                              m))),
        max_abs_err(init, minimizer.windowed_get_minimizer_torch(
            pa_init, pa_init.fwd_k, k - 1, m)))
    state0 = minimizer.MinimizerState(*(x[:, -1].contiguous()
                                        for x in init))
    fresh = torch.ones(B, dtype=torch.bool, device=dev)
    return codes, pa, state0, fresh, init_err


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


def row_inputs(em_rows, emitted, B: int, L_out: int, windowed: bool, dev,
               seed: int = 1234) -> tuple:
    """rows_from_emissions' inputs from the state machine's rows and the
    epilogue's outputs: ragged valid spans (each lane valid from a start
    in its first eighth, windowed, or column 0, to an end in its last
    quarter), first_valid at the start."""
    boundary, use_rc = em_rows[0], em_rows[1]
    mini_idx, key, bucket = emitted[0], emitted[6], emitted[7]
    rng = np.random.default_rng(seed + 1)
    start = (rng.integers(0, max(1, L_out // 8), B) if windowed
             else np.zeros(B, np.int64))
    end = rng.integers(L_out - L_out // 4, L_out + 1, B)
    pos = torch.arange(L_out, device=dev)[None, :]
    start = torch.from_numpy(start).to(dev)[:, None]
    valid = (pos >= start) & (pos < torch.from_numpy(end).to(dev)[:, None])
    return (key, bucket, mini_idx, use_rc, valid, pos == start, boundary)


def measure(name: str, kmb, B: int, L_out: int, windowed: bool, dev,
            timed: bool = True, against: tuple = ()) -> list:
    """The five kernels at one geometry against their plain versions
    (raise on any difference); with `timed`, their times and bounds,
    and each `against` tree's kernels in turns with this tree's
    (time_turns). Returns one dict per kernel, in the order
    positions, rescan, state_scan, emit, skl_rows."""
    from brisk_tpu_torch.index import sklstore
    from brisk_tpu_torch.ops import enumerate as enum_ops
    from brisk_tpu_torch.ops import minimizer
    k, m, b = kmb
    margin = k - 1
    with_unique = windowed and k <= 32
    codes, pa, state0, fresh, init_err = inputs(kmb, B, L_out, dev)
    L_buf = margin + L_out

    def positions():
        return minimizer.position_pipeline(codes, k, m)

    def positions_plain():
        return minimizer.position_pipeline_torch(codes, k, m)

    pos_err = max(init_err, max_abs_err(flat_positions(positions()),
                                        flat_positions(positions_plain())))

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

    scan_out = scan()
    scan_err = max_abs_err(flat_scan(scan_out), flat_scan(scan_plain()))
    em_rows = scan_out[0]
    emit_args = (em_rows[1], em_rows[2], em_rows[3], em_rows[4], pa.fwd_k,
                 pa.rc_k, k, m, b)

    def emit():
        return enum_ops._emit(*emit_args)

    def emit_plain():
        return enum_ops._emit_torch(*emit_args)

    emitted = emit()
    emit_err = max_abs_err(emitted, emit_plain())
    row_cap = row_cap_of(L_out, windowed)
    row_args = row_inputs(em_rows, emitted, B, L_out, windowed, dev) + (
        k, m, b, row_cap)

    def assemble():
        return sklstore.rows_from_emissions(*row_args)

    def assemble_plain():
        return sklstore.rows_from_emissions_torch(*row_args)

    rows_err = max_abs_err(assemble(), assemble_plain())
    torch.cuda.synchronize()
    errs = dict(positions=pos_err, rescan=err, state_scan=scan_err,
                emit=emit_err, skl_rows=rows_err)
    if any(errs.values()):
        raise RuntimeError(f"{name}: kernel != plain version (max_abs_err "
                           f"{errs})")
    out = [dict(kernel="positions", geometry=name, k=k, m=m, R=B, L=L_buf,
                  max_abs_err=pos_err, **bound(*positions_work(B, L_buf, m))),
             dict(kernel="rescan", geometry=name, k=k, m=m, R=B, L=L_buf,
                  max_abs_err=err,
                  **bound(*rescan_work(B, L_buf, k, m, with_unique))),
             dict(kernel="state_scan", geometry=name, k=k, m=m, B=B,
                  L_out=L_out, max_abs_err=scan_err,
                  **bound(state_scan_bytes(B, L_out))),
             dict(kernel="emit", geometry=name, k=k, m=m, B=B, L_out=L_out,
                  max_abs_err=emit_err, **bound(emit_bytes(B, L_out))),
             dict(kernel="skl_rows", geometry=name, k=k, m=m, B=B, L=L_out,
                  row_cap=row_cap, max_abs_err=rows_err,
                  **bound(skl_rows_bytes(row_args[4], row_args[5],
                                         row_args[6], k, m, b, row_cap)))]
    if timed:
        for row, fn, plain, flat_fn in (
                (out[0], positions, positions_plain, flat_positions),
                (out[1], rescan, rescan_plain, flat),
                (out[2], scan, scan_plain, flat_scan),
                (out[3], emit, emit_plain, list),
                (out[4], assemble, assemble_plain, list)):
            row["device_ms"] = device_ms(fn)
            row["kernel_ms"] = bench_expand.time_ms(fn)
            row["plain_ms"] = bench_expand.time_ms(plain, reps=3, calls=1)
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            row["library_ms"] = None
            others = tuple(d for d in against
                           if has_source(d, row["kernel"]))
            if others:
                row.update(time_turns(fn, others))
                want = flat_fn(plain())
                for other in row["against"]:
                    with kernels_from(other["csrc"]):
                        other["max_abs_err"] = max_abs_err(flat_fn(fn()),
                                                           want)
    return out


def measure_rows(name: str, k_arg: int, m: int, R: int, L: int, dev,
                 seed: int = 1234, timed: bool = False,
                 against: tuple = ()) -> list:
    """The position pipeline and the rescan alone over (R, L) rows of
    random codes (the rows of rekey._rekey_batch at L = k, of a
    fresh-lane init at L = k-1) against their plain versions; raise on
    any difference. With `timed`, the position pipeline's times and bound
    as in `measure`, in turns with each `against` tree's. Returns one
    dict each, positions first."""
    from brisk_tpu_torch.ops import minimizer
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 4, (R, L))).to(dev)

    def positions():
        return minimizer.position_pipeline(codes, k_arg, m)

    def positions_plain():
        return minimizer.position_pipeline_torch(codes, k_arg, m)

    pa = positions()
    pos_err = max_abs_err(flat_positions(pa),
                          flat_positions(positions_plain()))
    err = max_abs_err(
        minimizer.windowed_get_minimizer(pa, pa.fwd_k, k_arg, m),
        minimizer.windowed_get_minimizer_torch(pa, pa.fwd_k, k_arg, m))
    torch.cuda.synchronize()
    if pos_err or err:
        raise RuntimeError(f"{name}: kernel != plain version (max_abs_err "
                           f"positions {pos_err}, rescan {err})")
    pos = dict(kernel="positions", geometry=name, k=k_arg, m=m, R=R, L=L,
               max_abs_err=pos_err, **bound(*positions_work(R, L, m)))
    if timed:
        pos["device_ms"] = device_ms(positions)
        pos["kernel_ms"] = bench_expand.time_ms(positions)
        pos["plain_ms"] = bench_expand.time_ms(positions_plain, reps=3,
                                               calls=1)
        pos["share_of_bound"] = pos["bound_ms"] / pos["device_ms"]
        pos["library_ms"] = None
        others = tuple(d for d in against if has_source(d, "positions"))
        if others:
            pos.update(time_turns(positions, others))
            want = flat_positions(positions_plain())
            for other in pos["against"]:
                with kernels_from(other["csrc"]):
                    other["max_abs_err"] = max_abs_err(
                        flat_positions(positions()), want)
    return [pos, dict(kernel="rescan", geometry=name, k=k_arg, m=m, R=R,
                      L=L, max_abs_err=err)]


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
    print(json.dumps(measure_rows(*REKEY_ROWS, dev, timed=True,
                                  against=tuple(args.against))[0]),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
