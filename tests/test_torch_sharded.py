"""The sharded programs of the port (parallel.sharded, 8 shards in one
process on the CPU) and the point / join reads of index.sklstore against
brisk_tpu's on the 8-device CPU mesh, on the same inputs: the routing
buffer, the windowed insert's every per-shard arena array, counters,
certificates, end states, overflow flags and chain (k=31, k=63, forced
spill), the same for its split into sharded_flush_body and append_blocks
(what the card's CUDA graph runs) across a growth of the arenas, the host-built row delivery, bucket_slice / probe (hits, misses,
keys split across segments) and query_join_keys_total. Exact
comparisons throughout."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import pipeline as j_pipeline
from brisk_tpu.index import sklstore as j_skl
from brisk_tpu.io import windows as j_windows
from brisk_tpu.parallel import sharded as j_sharded
from brisk_tpu_torch import _u32
from brisk_tpu_torch.api import Brisk as TBrisk
from brisk_tpu_torch.index import keying, pipeline, sklstore, store
from brisk_tpu_torch.io import fasta
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.ops import enumerate as enum_ops
from brisk_tpu_torch.params import Parameters
from brisk_tpu_torch.parallel import sharded

torch.set_num_threads(2)

N_SHARDS = 8
FIELDS = ("bucket", "meta", "nucs", "data", "offs", "n_rows", "n_fin_rows",
          "n_fin_kmers")


@pytest.fixture(scope="module")
def jmesh():
    return j_sharded.make_mesh(N_SHARDS)


def _np(x) -> np.ndarray:
    """Either package's array as numpy int64 (u32 bit patterns read as
    unsigned)."""
    if isinstance(x, torch.Tensor):
        return (_u32.to_np(x) if x.dtype == torch.int32
                else x.cpu().numpy()).astype(np.int64)
    return np.asarray(x).astype(np.int64)


def assert_same_state(t_state, j_state, what: str) -> None:
    for name in FIELDS:
        np.testing.assert_array_equal(_np(getattr(t_state, name)),
                                      _np(getattr(j_state, name)),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("cap", [2, 64])
@pytest.mark.parametrize("skewed", [False, True])
def test_route_local_matches(skewed, cap):
    rng = np.random.default_rng(cap + skewed)
    n_src, W, N = 3, 4, 300
    rows = rng.integers(0, 1 << 32, (n_src, W, N), dtype=np.uint64
                        ).astype(np.uint32)
    if skewed:  # most rows to two hot buckets
        rows[:, 0] = rng.choice(np.array([5, 13, 77, 4096], np.uint32),
                                (n_src, N), p=[0.6, 0.3, 0.05, 0.05])
    valid = rng.random((n_src, N)) < 0.8
    rows[:, 0][~valid] = 0xFFFFFFFF
    buf, ok = sharded._route_local(_u32.from_np(rows, "cpu"),
                                   _u32.from_np(rows[:, 0], "cpu"),
                                   torch.from_numpy(valid), N_SHARDS, cap)
    assert buf.shape == (n_src, N_SHARDS, cap, W)
    for s in range(n_src):
        jbuf, jok = j_sharded._route_local(
            jnp.asarray(rows[s]), jnp.asarray(rows[s, 0]),
            jnp.asarray(valid[s]), N_SHARDS, cap)
        np.testing.assert_array_equal(_u32.to_np(buf[s]), np.asarray(jbuf))
        np.testing.assert_array_equal(ok[s].numpy(), np.asarray(jok))
    if cap == 2:
        assert not bool(ok[valid].all())  # the cap must bite


def _records(k, seed, n=20):
    rng = random.Random(seed)
    recs = ["".join(rng.choice("ACGT") for _ in range(n_))
            for n_ in [6000] + [rng.randint(k, 700) for _ in range(n)]]
    # a poly-A-rich record: hot buckets and repeated rows
    recs.append("".join("A" if rng.random() < 0.9 else rng.choice("CGT")
                        for _ in range(900)))
    return recs


@pytest.mark.parametrize("k,m,b,route_cap", [(31, 11, 8, None),
                                             (31, 11, 8, 2),
                                             (63, 21, 14, None)])
def test_insert_windows_sklonly_matches(jmesh, k, m, b, route_cap):
    """Two window stacks (the second continues the first's chain and
    appends behind its rows): every arena array, counter, certificate,
    end state, overflow flag and the chain equal brisk_tpu's."""
    B_local, S, window = 4, 2, 144
    B = N_SHARDS * B_local
    row_cap = window // 4
    route_cap = route_cap or 4 * B_local * row_cap // N_SHARDS
    nw = sklstore.skl_dims(k, m, b)[3]
    packer = j_windows.WindowPacker(k, m, B, l_out=window)
    batches = list(packer.pack(iter(_records(k, k + (route_cap or 0)))))
    assert len(batches) >= 2 * S, "need two full stacks"
    tmesh = sharded.make_mesh(N_SHARDS, "cpu")
    rcap = 1 << 14
    jst = j_sharded.sharded_skl_empty(N_SHARDS, rcap, 1 << 12, nw, jmesh)
    tst = sharded.sharded_skl_empty(N_SHARDS, rcap, 1 << 12, nw, tmesh)
    jch, tch = j_pipeline.zero_chain(), pipeline.zero_chain("cpu")
    spilled = 0
    for f in range(2):
        stack = batches[f * S:(f + 1) * S]
        codes = np.stack([bt.codes for bt in stack])
        vs = np.stack([bt.valid_start for bt in stack])
        ve = np.stack([bt.valid_end for bt in stack])
        (jst, j_sk, j_km, j_sp, j_cert, j_ends, j_ovf,
         jch) = j_sharded.sharded_insert_windows_sklonly(
            jst, jnp.asarray(codes), jnp.asarray(vs), jnp.asarray(ve), jch,
            k=k, m=m, b=b, mesh=jmesh, row_cap=row_cap,
            skl_route_cap=route_cap)
        (tst, t_sk, t_km, t_sp, t_cert, t_ends, t_ovf,
         tch) = sharded.sharded_insert_windows_sklonly(
            tst, torch.from_numpy(codes), torch.from_numpy(vs),
            torch.from_numpy(ve), tch, k, m, b, tmesh, row_cap, route_cap)
        assert_same_state(tst, jst, f"stack {f}")
        assert (int(t_sk), int(t_km), int(t_sp)) == (int(j_sk), int(j_km),
                                                     int(j_sp))
        for got, want in [(t_cert, j_cert), (t_ovf, j_ovf)] + list(
                zip(t_ends, j_ends)):
            np.testing.assert_array_equal(_np(got), _np(want))
        for got, want in zip(list(tch[0]) + [tch[1]],
                             list(jch[0]) + [jch[1]]):
            assert int(got) == int(want)
        spilled += int(t_sp)
    assert int(tst.n_rows.sum()) > 0
    if route_cap == 2:
        assert spilled > 0


@pytest.mark.parametrize("route_cap", [None, 2])
def test_sharded_body_and_append_match_brisk_tpu(jmesh, route_cap):
    """sharded_flush_body (what a CUDA graph replays on the card) then
    append_blocks (what runs after the replay), two stacks with the chain
    carried and both packages' arenas grown by sharded_skl_grow between
    them, against brisk_tpu's jitted sharded_insert_windows_sklonly:
    every arena array whole, the counters, certificates, end states,
    overflow flags and the chain. The blocks are live first: each
    shard's n_live rows lead, the rest hold an INVALID bucket. The
    route cap of 2 spills, the default does not."""
    k, m, b = 31, 11, 8
    B_local, S, window = 4, 2, 144
    B = N_SHARDS * B_local
    row_cap = window // 4
    route_cap = route_cap or 4 * B_local * row_cap // N_SHARDS
    nw = sklstore.skl_dims(k, m, b)[3]
    packer = j_windows.WindowPacker(k, m, B, l_out=window)
    batches = list(packer.pack(iter(_records(k, 7 + route_cap))))
    assert len(batches) >= 2 * S, "need two full stacks"
    tmesh = sharded.make_mesh(N_SHARDS, "cpu")
    rcap = 1 << 14
    jst = j_sharded.sharded_skl_empty(N_SHARDS, rcap, 1 << 12, nw, jmesh)
    tst = sharded.sharded_skl_empty(N_SHARDS, rcap, 1 << 12, nw, tmesh)
    jch, tch = j_pipeline.zero_chain(), pipeline.zero_chain("cpu")
    n = N_SHARDS * route_cap + B_local * row_cap
    spilled = 0
    for f in range(2):
        if f:
            jst = j_sharded.sharded_skl_grow(jst, 2 * rcap, jmesh)
            tst = sharded.sharded_skl_grow(tst, 2 * rcap, tmesh)
        stack = batches[f * S:(f + 1) * S]
        codes = np.stack([bt.codes for bt in stack])
        vs = np.stack([bt.valid_start for bt in stack])
        ve = np.stack([bt.valid_end for bt in stack])
        (jst, j_sk, j_km, j_sp, j_cert, j_ends, j_ovf,
         jch) = j_sharded.sharded_insert_windows_sklonly(
            jst, jnp.asarray(codes), jnp.asarray(vs), jnp.asarray(ve), jch,
            k=k, m=m, b=b, mesh=jmesh, row_cap=row_cap,
            skl_route_cap=route_cap)
        (blocks, n_live, t_sk, t_km, t_sp, t_cert, t_ends, t_ovf,
         tch) = sharded.sharded_flush_body(
            torch.from_numpy(codes), torch.from_numpy(vs),
            torch.from_numpy(ve), tch, k, m, b, tmesh, row_cap, route_cap)
        assert blocks.shape == (S, N_SHARDS, 2 + nw, n)
        assert blocks.dtype == torch.int32 and n_live.shape == (S, N_SHARDS)
        live = blocks[:, :, 0] != -1
        assert torch.equal(live.sum(2), n_live)
        assert torch.equal(live, torch.arange(n) < n_live[..., None])
        rows0 = tst.n_rows.clone()
        tst = sharded.append_blocks(tst, blocks, n_live)
        assert torch.equal(tst.n_rows, rows0 + n_live.sum(0))
        assert_same_state(tst, jst, f"stack {f}")
        assert (int(t_sk), int(t_km), int(t_sp)) == (int(j_sk), int(j_km),
                                                     int(j_sp))
        for got, want in [(t_cert, j_cert), (t_ovf, j_ovf)] + list(
                zip(t_ends, j_ends)):
            np.testing.assert_array_equal(_np(got), _np(want))
        for got, want in zip(list(tch[0]) + [tch[1]],
                             list(jch[0]) + [jch[1]]):
            assert int(got) == int(want)
        spilled += int(t_sp)
    assert tst.bucket.shape[1] == 2 * rcap and int(tst.n_rows.sum()) > 0
    assert (spilled > 0) == (route_cap == 2)


def test_append_skl_rows_matches(jmesh):
    """Host-built row buffers (INVALID-bucket padded, live rows in any
    order) dense-append per shard behind existing rows."""
    rng = np.random.default_rng(4)
    nw, rcap, cap_r = 2, 256, 9
    tmesh = sharded.make_mesh(N_SHARDS, "cpu")
    jst = j_sharded.sharded_skl_empty(N_SHARDS, rcap, 1 << 12, nw, jmesh)
    tst = sharded.sharded_skl_empty(N_SHARDS, rcap, 1 << 12, nw, tmesh)
    for _ in range(3):
        buf = rng.integers(0, 1 << 32, (N_SHARDS, cap_r, 2 + nw),
                           dtype=np.uint64).astype(np.uint32)
        buf[rng.random((N_SHARDS, cap_r)) < 0.4, 0] = 0xFFFFFFFF
        jst = j_sharded.sharded_append_skl_rows(jst, jnp.asarray(buf), jmesh)
        tst = sharded.sharded_append_skl_rows(
            tst, _u32.from_np(buf, "cpu"), tmesh)
        assert_same_state(tst, jst, "append")
    grown = sharded.sharded_skl_grow(tst, 2 * rcap, tmesh)
    assert_same_state(grown, j_sharded.sharded_skl_grow(jst, 2 * rcap, jmesh),
                      "grow")


@pytest.fixture(scope="module")
def two_segments():
    """A port arena whose keys are split across two finalize segments
    (the same file inserted twice), and the same arena for brisk_tpu."""
    k, m, b = 31, 11, 8
    br = TBrisk(Parameters(k, m, b), batch=16, window=64, device="cpu")
    br.insert_file("data/test.fa")
    br.finalize()
    br.insert_file("data/test.fa")
    br.finalize()
    assert len(br._skl_segments) == 2
    cols = sklstore.to_numpy(br.skl)
    jst = j_skl.SklState(**{n: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                else jnp.int32(v)) for n, v in cols.items()})
    return br, jst, (k, m, b)


def test_bucket_slice_and_probe_match(two_segments):
    br, jst, (k, m, b) = two_segments
    counts = br.counts_dict()
    rng = np.random.default_rng(8)
    keys = sorted(counts)
    kmers = [pyref.num2str(keys[int(i)], k)
             for i in rng.integers(0, len(keys), 40)]
    kmers += ["ACGT" * 7 + "ACG", "T" * 31]  # most likely absent
    buckets, cols = keying.key_batch(keying.strs_to_codes(kmers), m, b)
    segs = br._skl_segments
    bcol = sklstore.fetch_rows(br.skl.bucket, 0, int(br.skl.n_fin_rows))
    split = 0
    for i, bk in enumerate(buckets):
        got = sklstore.bucket_slice(br.skl, int(bk), segs)
        assert got == j_skl.bucket_slice(jst, int(bk), segs)
        assert got == sklstore.bucket_slice(br.skl, int(bk), segs, bcol)
        split += len(got) > 1
        c = cols[:, i:i + 1]
        tf, tv = sklstore.probe(br.skl, c, int(bk), k, m, b, segments=segs)
        jf, jv = j_skl.probe(jst, c, int(bk), k, m, b, segments=segs)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)
        assert tv.dtype == np.uint32
        # the host probe over the same segments agrees
        hf, hv = sklstore.probe_np(sklstore.host_cache(br.skl), c, int(bk),
                                   k, m, b, segments=segs)
        np.testing.assert_array_equal(tf, hf)
        np.testing.assert_array_equal(tv, hv)
    assert split > 0, "no key split across segments"
    # a whole bucket's keys in one call (Q > 1), hits and misses mixed
    bk = int(buckets[0])
    sel = np.nonzero(buckets == bk)[0]
    c = np.concatenate([cols[:, sel], cols[:, -2:]], axis=1)
    tf, tv = sklstore.probe(br.skl, c, bk, k, m, b, segments=segs)
    jf, jv = j_skl.probe(jst, c, bk, k, m, b, segments=segs)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("chunk", [1 << 26, 1 << 12])
def test_query_join_keys_total_matches(two_segments, chunk):
    """The query enumerated straight to packed keys (the facade's route)
    joined against the two-segment arena, in one chunk and in several
    padded chunks."""
    br, jst, (k, m, b) = two_segments
    qk, ql = [], []
    for path in ("data/test.fa", "data/debug_test.fa"):  # hits, misses
        carry = enum_ops.zero_carry(64)
        for bt in fasta.fasta_batches(path, k, 64, 128):
            em, carry = enum_ops.enumerate_batch(
                torch.from_numpy(bt.codes), torch.from_numpy(bt.fresh),
                torch.from_numpy(bt.valid_end), carry, k, m, b)
            qk.append(_u32.to_i32(store.make_keys(
                em.bucket.reshape(-1), em.key.reshape(4, -1),
                em.mini_idx.reshape(-1), k, b)))
            ql.append(em.valid.reshape(-1))
    qk, ql = torch.cat(qk, 1), torch.cat(ql)
    got = sklstore.query_join_keys_total(br.skl, qk, ql, k, m, b,
                                         chunk=chunk)
    want = j_skl.query_join_keys_total(jst, _u32.to_np(qk),
                                       ql.numpy().astype(np.uint32),
                                       k, m, b, chunk=chunk)
    assert got == want > 0
