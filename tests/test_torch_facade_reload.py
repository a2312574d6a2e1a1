"""The sharded facade after a reload: each shard's bucket-sorted runs come
back. Two insert + finalize cycles leave two runs per shard; the `.npz`
files of both packages keep no run list, and the port's
ShardedBrisk.load rebuilds the runs from each shard's bucket column
(sklstore.runs_from_bucket), so every get_canonical after the reload
equals its value before save and the oracle's count. Arenas stay equal
to brisk_tpu's array for array. (brisk_tpu's own facade still declares
one run per shard on load and misses keys; it is not changed.)"""

import random

import numpy as np
import pytest
import torch

from brisk_tpu.parallel import sharded as j_sharded
from brisk_tpu.parallel.facade import ShardedBrisk as JSharded
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch.api import Brisk as TBrisk
from brisk_tpu_torch.index import sklstore
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters
from brisk_tpu_torch.parallel.facade import ShardedBrisk as TSharded
from tests.test_torch_facade import arena_np, assert_same_arena

torch.set_num_threads(2)

K, M, B = 31, 11, 8
GEO = dict(batch_per_shard=8, window=64, stack=2)
N_SAMPLE = 240


def _cycle_files(tmp) -> list:
    """Two FASTA files of 3 random 3 kb records each, one per cycle."""
    rng = random.Random(41)
    paths = []
    for c in range(2):
        recs = ["".join(rng.choice("ACGT") for _ in range(3000))
                for _ in range(3)]
        path = str(tmp / f"cycle{c}.fa")
        with open(path, "w") as fh:
            fh.write("".join(f">c{c}r{i}\n{s}\n" for i, s in enumerate(recs)))
        paths.append(path)
    return paths


def _oracle(paths) -> dict:
    out = {}
    for p in paths:
        for kv, c in pyref.count_fasta(p, K, M).items():
            out[kv] = (out.get(kv, 0) + c) % 256
    return out


def _sample(paths, n: int) -> list:
    """n k-mers at random positions of the records, and a few absent."""
    rng = np.random.default_rng(9)
    seqs = [s for p in paths for s in pyref.read_fasta_chunks(p)]
    out = []
    for i in rng.integers(0, len(seqs), n - 2):
        s = seqs[int(i)]
        p = int(rng.integers(0, len(s) - K + 1))
        out.append(s[p:p + K])
    return out + [("ACGT" * 8)[:K], "A" * K]


@pytest.fixture(scope="module")
def cycled(tmp_path_factory):
    """Both facades through two insert + finalize cycles, saved."""
    tmp = tmp_path_factory.mktemp("reload")
    paths = _cycle_files(tmp)
    jb = JSharded(JParameters(K, M, B), mesh=j_sharded.make_mesh(8), **GEO)
    tb = TSharded(Parameters(K, M, B), n_devices=8, device="cpu", **GEO)
    for path in paths:
        for br in (jb, tb):
            br.insert_file(path)
            br.finalize()
    sample = _sample(paths, N_SAMPLE)
    before = [tb.get_canonical(s) for s in sample]
    ck = {"torch": str(tmp / "t.npz"), "jax": str(tmp / "j.npz")}
    tb.save(ck["torch"])
    jb.save(ck["jax"])
    return dict(paths=paths, jb=jb, tb=tb, sample=sample, before=before,
                ckpt=ck)


def test_two_cycles_leave_two_runs_per_shard(cycled):
    tb, jb = cycled["tb"], cycled["jb"]
    assert_same_arena(arena_np(tb), arena_np(jb), "two cycles")
    assert tb._skl_segments == jb._skl_segments
    assert all(len(tb._skl_segments[d]) >= 2 for d in range(8))
    exp = _oracle(cycled["paths"])
    for s, c in zip(cycled["sample"], cycled["before"]):
        v = pyref.str2num(s)
        assert c == exp.get(v, exp.get(pyref.revcomp(v, K))), s


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_reload_keeps_every_run_and_every_get(cycled, writer):
    """ShardedBrisk.load of either package's file: the arena equals
    brisk_tpu's, each shard's runs are rebuilt (at least two, covering
    every finalized row) and every sampled get_canonical equals its value
    before save and the oracle."""
    back = TSharded.load(cycled["ckpt"][writer], device="cpu", **GEO)
    assert_same_arena(arena_np(back), arena_np(cycled["jb"]), "loaded")
    nfr = arena_np(back)["n_fin_rows"]
    for d in range(8):
        runs = back._skl_segments[d]
        assert len(runs) >= 2, (d, runs)
        assert runs[0][0] == 0 and runs[-1][1] == nfr[d]
        assert all(a[1] == c[0] for a, c in zip(runs, runs[1:]))
    got = [back.get_canonical(s) for s in cycled["sample"]]
    assert got == cycled["before"]
    exp = _oracle(cycled["paths"])
    for s, c in zip(cycled["sample"], got):
        v = pyref.str2num(s)
        assert c == exp.get(v, exp.get(pyref.revcomp(v, K))), s
    assert back.counts_dict() == cycled["tb"].counts_dict()


def test_brisk_load_rebuilds_runs_without_a_run_list(tmp_path):
    """Brisk.load of a file without `skl_segments` rebuilds the runs of
    two finalize cycles from the bucket column: the same runs as before
    save, and the same lookups."""
    paths = _cycle_files(tmp_path)
    br = TBrisk(Parameters(K, M, B), batch=16, window=64, device="cpu")
    for path in paths:
        br.insert_file(path)
        br.finalize()
    assert len(br._skl_segments) == 2
    sample = _sample(paths, 60)
    before = br.get_many(sample)
    ck = str(tmp_path / "b.npz")
    br.save(ck)
    z = dict(np.load(ck))
    del z["skl_segments"]
    bare = str(tmp_path / "bare.npz")
    np.savez_compressed(bare, **z)
    back = TBrisk.load(bare, batch=16, window=64, device="cpu")
    runs = back._skl_segments
    assert runs[0][0] == 0 and runs[-1][1] == br._skl_segments[-1][1]
    assert len(runs) >= 2
    assert back.get_many(sample) == before


@pytest.mark.parametrize("col,n,want", [
    ([], 0, []),
    ([5, 9], 0, []),
    ([1, 1, 2, 7, 7], 5, [(0, 5)]),
    ([1, 4, 9, 2, 3, 8, 0], 7, [(0, 3), (3, 6), (6, 7)]),
    ([1, 4, 4, 6, 9], 5, [(0, 5)]),                  # two runs that merge
    ([1, 2, 3, 5, 0], 5, [(0, 4), (4, 5)]),          # a drop at the last row
    ([3, 1, 0xFFFFFFFF, 0], 3, [(0, 1), (1, 3)]),    # rows past n ignored
    ([0xFFFFFFFE, 0xFFFFFFFF, 0x80000000], 3, [(0, 2), (2, 3)]),  # u32 order
])
def test_runs_from_bucket(col, n, want):
    got = sklstore.runs_from_bucket(np.asarray(col, dtype=np.uint32), n)
    assert got == want
    for lo, hi in got:
        seg = np.asarray(col[lo:hi], dtype=np.uint32)
        assert np.all(seg[1:] >= seg[:-1])
