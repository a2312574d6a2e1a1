"""Costs of the sort, scan and gather primitives under the index, at the
bench scale, on one CUDA card (the counterpart of the repo's
scripts/profile_sort.py):

    python -m brisk_tpu_torch.profile_sort [--device cuda|cpu]

On N = 2^25 random u32 columns (int32 bit patterns, seed 0):
  - the port's stable multi-key sort (_u32.lexsort) for each
    (num_keys, payload) pair the reference lists, the payload columns
    gathered by the permutation;
  - the dedup scans: a u32 cumsum (in int64, masked to 32 bits as the
    port does) and a cummax of each run's base; beside them, on a card,
    the same runs' totals and ranks by the port's kernel
    (kernels.run_totals, csrc/run_scan.cu: `run_totals_ms`);
  - a random gather of 4 columns;
  - the row-batched sorts, 1024 x 32K and 128 x 256K, 3 keys + 1
    payload along each row.
Each output goes through a digest of every element xor its neighbour
(the column xor itself rolled by one, summed), as the reference's does,
so every output element is computed and read. Median of 3
timed calls after a warm one, in ms and Mrows/s. The reference's
bitonic-merge probe is left out: it was a design experiment for the
TPU's store, and no path of the port merges that way.
"""

import argparse
import json
import sys

import torch

from brisk_tpu_torch import bench, kernels

# (num_keys, payload columns), as scripts/profile_sort.py lists them
SORTS = ((3, 1), (1, 1), (1, 3), (2, 2), (6, 1), (2, 1), (1, 0))
M32 = 0xFFFFFFFF


def digest(o: torch.Tensor) -> torch.Tensor:
    """Sum of each u32 element xor its neighbour (int64 scalar)."""
    o = o.to(torch.int64) & M32
    return (o ^ torch.roll(o, 1, dims=-1)).sum()


def timed(dev, label: str, fn, n_rows: int) -> dict:
    """One measurement's row: bench.median_s of fn (its digests are read
    back), and the rate over n_rows."""
    t = bench.median_s(dev, fn)
    return dict(stage=label, ms=1e3 * t, mrows_per_s=n_rows / t / 1e6,
                rows=n_rows)


def profile(dev: torch.device, n: int = 1 << 25,
            row_batches=((1024, 1 << 15), (128, 1 << 18))) -> list:
    """Every measurement of the module note on n rows; the row-batched
    sorts at the (rows, width) shapes of row_batches (each rows * width
    <= n). One dict per measurement."""
    from brisk_tpu_torch._u32 import lexsort
    g = torch.Generator(device=dev).manual_seed(0)
    cols = [torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                          device=dev, generator=g) for _ in range(8)]
    out = []
    for nk, npay in SORTS:
        def sort(nk=nk, npay=npay):
            perm = lexsort(cols[:nk])
            return [digest(c[perm]) for c in cols[:nk + npay]]
        out.append(timed(dev, f"lexsort num_keys={nk} payload={npay}", sort,
                         n))

    def scans():
        x = cols[0]
        val = cols[1].to(torch.int64) & M32
        first = x != torch.roll(x, 1)
        csum = torch.cumsum(val, 0) & M32
        base = torch.cummax(torch.where(first, (csum - val) & M32, 0),
                            0).values
        return [digest(base) + digest(csum)]

    row = timed(dev, "dedup scans (cumsum+cummax)", scans, n)
    row["run_totals_ms"] = None
    if dev.type == "cuda":
        val = cols[1].to(torch.int64) & M32
        first = cols[0] != torch.roll(cols[0], 1)
        row["run_totals_ms"] = 1e3 * bench.median_s(
            dev, lambda: [digest(x) for x in kernels.run_totals(val, first)])
    out.append(row)

    def gather4():
        idx = (cols[0].to(torch.int64) & M32) >> 7
        idx = idx & (n - 1)
        return [digest(c[idx]) for c in cols[:4]]

    out.append(timed(dev, "random gather x4 cols", gather4, n))
    for rows, width in row_batches:
        def batched(rows=rows, width=width):
            ops = [c[:rows * width].reshape(rows, width) for c in cols[:4]]
            perm = lexsort(ops[:3], dim=1)
            return [digest(torch.gather(o, 1, perm).reshape(-1))
                    for o in ops]
        out.append(timed(dev, f"row-sorted ({rows}, {width}) 3key+1pay",
                         batched, rows * width))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sort / scan / gather costs at 2^25 rows")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    dev = bench.device_of(a.device)
    info = bench.card_info(dev)
    print(f"{info['device_name']}, {info['power_limit_w']}", flush=True)
    for row in profile(dev):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
