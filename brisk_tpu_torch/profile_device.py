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

The last two stand where the reference times its legacy per-k-mer
insert_many and store.compact_auto, which the port does not have: the
product insert and its finalize are what Brisk.insert_file and
Brisk.finalize run. Prints the card's name and power limit, then one
JSON line per stage. A CPU run (`--device cpu`) gives host times.
"""

import argparse
import json
import sys

import numpy as np
import torch

from brisk_tpu_torch import bench


def timed(dev, label: str, fn, per: int) -> dict:
    """One stage's row: bench.median_s of fn, and the k-mer rate for
    `per` k-mers."""
    t = bench.median_s(dev, fn)
    return dict(stage=label, ms=1e3 * t, mkmer_per_s=per / t / 1e6, calls=3)


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

    def insert(finalize: bool):
        skl = sklstore.empty(rcap, 1 << 14, nw, dev)
        out = pipeline.insert_flat_sklnative(
            skl, chunk4, vs, ve, pipeline.zero_chain(dev), k, m, b,
            row_cap, packer.l_buf, packer.useful)
        skl = out[0]
        if finalize:
            skl = sklstore.finalize_device(skl, k, m, b)
            return skl.n_fin_kmers
        return skl.n_rows

    rows.append(timed(dev, "insert_flat_sklnative", lambda: insert(False),
                      n_kmers))
    rows.append(timed(dev, "insert+finalize", lambda: insert(True),
                      n_kmers))
    for r in rows:
        r.update(k=k, batch=batch, length=length, stack=stack)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-stage times of the k <= 32 insert")
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
