"""The least time of the enumerator's five kernels on one NVIDIA H100 SXM
at 700 W, for one batch of an insert.

Frozen from brisk_tpu_torch/bench_enumerate.py (commit 44e47b2): its
byte and float64-addition model of each kernel (each input it needs read
once, each output written once; the decycling sums' additions), at the
geometry a configuration's insert gives each batch: per batch the
position pipeline and the rescan over the (B, L_buf) lanes and over the
fresh lanes' (B, k-1) rows, the state machine and the epilogue over the
(B, L_out) emitting positions, the row assembly over them. The row
assembly's bytes depend on the emissions; here they are counted from the
job's k-mers and super-k-mers, a lower bound (a row split at the size cap
and a padded slot read for its meta are left out).
"""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak at 700 W
# float64 additions outside the tensor cores: the data sheet's 34 TFLOP/s
# counts an FMA as two operations, a chain of additions reaches half
FP64_ADDS_PER_S = 17e12
KERNELS = ("positions", "rescan", "state_scan", "emit", "skl_rows")


def rescan_work(R: int, L: int, k_arg: int, m: int, with_unique: bool):
    """(bytes, float64 additions) of one rescan over (R, L)."""
    n = R * L
    bytes_ = n * (9 * 8 + 1 + 6 * 8 + 1 + (1 if with_unique else 0))
    W = k_arg - m + 1
    clean_max = (64 - 2 * m) // 2
    varying = max(0, min(W - 1, 31) - clean_max)
    constant = W - 1 >= 32 and W - 1 > clean_max
    return bytes_, (n * varying + constant) * 2 * (m - 1)


def positions_work(R: int, L: int, m: int):
    """(bytes, float64 additions) of one position pipeline over (R, L)."""
    n = R * L
    return n * (8 + 17 * 8 + 2), n * 2 * (m - 1)


def emit_bytes(B: int, L_out: int) -> int:
    return B * L_out * (7 * 8 + 1 + 14 * 8)


def state_scan_bytes(B: int, L_out: int) -> int:
    return B * L_out * (11 * 8 + 2 + 3 * 8 + 2) + B * (2 * 49 + 1)


def least_s(bytes_: int, fp64_adds: int = 0) -> float:
    return max(bytes_ / HBM_BYTES_PER_S, fp64_adds / FP64_ADDS_PER_S)


def batch_least_s(k: int, m: int, geo: dict) -> dict:
    """Least seconds of each kernel's launches in one batch, the row
    assembly's fixed part only (row_bytes_per_kmer / _per_superkmer give
    the rest)."""
    B, L_out, margin = geo["lanes"], geo["l_out"], k - 1
    L_buf = L_out + margin
    uniq = geo["windowed"] and k <= 32
    out_w = min(L_out, geo["row_cap"])
    return dict(
        positions=least_s(*positions_work(B, L_buf, m))
        + least_s(*positions_work(B, margin, m)),
        rescan=least_s(*rescan_work(B, L_buf, k, m, uniq))
        + least_s(*rescan_work(B, margin, k - 1, m, False)),
        state_scan=least_s(state_scan_bytes(B, L_out)),
        emit=least_s(emit_bytes(B, L_out)),
        skl_rows=least_s(3 * B * L_out
                         + B * (out_w * (2 + geo["row_words"]) * 8 + 1)))


def rows_least_s(n_kmers: int, n_superkmers: int) -> float:
    """The row assembly's emission-dependent bytes over a job: 17 per
    valid position, 24 per row start and 8 per kept start."""
    return least_s(17 * n_kmers + 32 * n_superkmers)
