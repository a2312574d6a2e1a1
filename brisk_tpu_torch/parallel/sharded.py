"""Sharded super-k-mer arenas: data-parallel record lanes, minimizer-space
sharding (port of the skl path of brisk_tpu.parallel.sharded).

  * record lanes are DATA-PARALLEL across shards: local shard s owns lanes
    [s*B_local, (s+1)*B_local) of this process's batch;
  * the index is sharded by REDUCED MINIMIZER: shard d owns every bucket
    with bucket % n_shards == d (the reference's `minimizer %
    mutex_number` lock-group keying, DenseMenuYo.hpp:150);
  * super-k-mer rows travel to their owner shard through a
    capacity-bounded all-to-all (multihost.exchange) and are appended to
    the owner's arena; rows past a destination's capacity SPILL to their
    source shard. Ownership is a routing heuristic, not a correctness
    invariant: every reader sums a key's counts over all shards.

The state is one `sklstore.SklState` whose tensors carry a leading axis
of this process's shards: bucket / meta / offs (n_local, rcap), nucs
(n_local, nw, rcap), data (n_local, kcap), n_rows / n_fin_rows /
n_fin_kmers (n_local,) int64. `brisk_tpu` runs one shard_map program per
device; here each step runs ONCE over every local lane and shard (the
insert is launch-bound, so the launch count must not grow with
n_shards): one enumeration of all local lanes, one row segmentation, a
routing pass batched over the source-shard axis, one exchange, one
live-first sort and one append batched over the destination axis.

Not ported (the per-k-mer IndexState programs only brisk_tpu's tests
and dry run call): sharded_insert_step, sharded_compact,
sharded_insert_windows, sharded_insert_windows_skl, sharded_append_buf,
sharded_append_valued_buf, sharded_lookup, sharded_grow, sharded_empty.
"""

from typing import Tuple

import torch

from brisk_tpu_torch._u32 import INVALID, to_i32, to_u32
from brisk_tpu_torch.index import pipeline, sklstore
from brisk_tpu_torch.ops import enumerate as enum_ops
from brisk_tpu_torch.ops.minimizer import MinimizerState
from brisk_tpu_torch.parallel import multihost
from brisk_tpu_torch.parallel.multihost import Mesh


def make_mesh(n_devices: int, device="cpu") -> Mesh:
    """One process holding n_devices shards on `device`."""
    return Mesh(n_devices, device)


def _route_local(rows: torch.Tensor, bucket: torch.Tensor,
                 valid: torch.Tensor, n_shards: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack each local source shard's (W, N) row words into an
    (n_shards, cap, W) routing buffer by destination (bucket %
    n_shards), batched over the leading source axis: rows (n_local, W,
    N), bucket and valid (n_local, N).

    Returns (buffer (n_local, n_shards, cap, W), routed mask (n_local, N)
    in ORIGINAL row order). A row's slot is its rank among the rows of
    its destination, in row order; rows at or past `cap` are not routed
    (the caller spills them to the source shard). Unused slots hold
    INVALID in every word."""
    n_local, W, N = rows.shape
    dev = rows.device
    dest = torch.where(valid, to_u32(bucket) % n_shards, n_shards)
    # (n_local, n_shards + 1, N): the row axis innermost, so the running
    # count is a scan along contiguous rows (a scan over an outer axis
    # runs one thread a column on the card)
    onehot = dest[:, None, :] == torch.arange(n_shards + 1,
                                              device=dev)[:, None]
    rank = torch.gather(onehot.cumsum(2), 1, dest[:, None, :])[:, 0] - 1
    ok = valid & (rank < cap)
    flat = torch.where(ok, dest * cap + rank, n_shards * cap)
    fill = -1 if rows.dtype == torch.int32 else INVALID
    buf = torch.full((n_local, n_shards * cap + 1, W), fill,
                     dtype=rows.dtype, device=dev)
    # not-routed rows all land on the one slot past the end, dropped here
    buf.scatter_(1, flat[..., None].expand(-1, -1, W), rows.transpose(1, 2))
    return buf[:, :-1].reshape(n_local, n_shards, cap, W), ok


def _chain_exact_sharded(em, end: MinimizerState, vs_i: torch.Tensor, chain,
                         margin: int, mesh: Mesh):
    """pipeline._chain_exact across shards. Lanes are sharded
    contiguously, so lane 0 of a shard continues the record of the
    previous shard's last lane: within one process this is
    pipeline._chain_exact over the concatenated local lanes. Across
    processes each process needs (a) the previous process's last-lane end
    state and (b) the composition of the (u, q) recurrence over all
    earlier processes. Each process's composition is the pair (exact of
    its last lane if its carry-in were False, ... if True); one gather of
    each, then a fold over the processes.

    chain is replicated: (global last end state, its exactness). Returns
    (exact (B,) bool, new chain)."""
    if mesh.group is None:
        return pipeline._chain_exact(em, end, vs_i, chain, margin)
    prev_end, prev_exact = chain
    last = multihost.gather(
        torch.stack([e[-1].to(torch.int64) for e in end]), mesh)
    if mesh.pid == 0:
        left = prev_end
    else:
        left = MinimizerState(*(last[mesh.pid - 1, f].to(e.dtype)
                                for f, e in enumerate(end)))
    no = torch.zeros((), dtype=torch.bool, device=vs_i.device)
    ex_f, _ = pipeline._chain_exact(em, end, vs_i, (left, no), margin)
    ex_t, _ = pipeline._chain_exact(em, end, vs_i, (left, ~no), margin)
    comp = multihost.gather(torch.stack([ex_f[-1], ex_t[-1]]), mesh)
    carry = prev_exact
    for i in range(mesh.n_proc):
        if i == mesh.pid:
            exact = torch.where(carry, ex_t, ex_f)
        carry = torch.where(carry, comp[i, 1], comp[i, 0])
    end_last = MinimizerState(*(last[mesh.n_proc - 1, f].to(e.dtype)
                                for f, e in enumerate(end)))
    return exact, (end_last, carry)


def _live_first(rec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each local shard's row block rec (n_local, 2+nw, n) int32 (bucket
    | meta | nucs words; dead rows have an INVALID bucket) with its live
    rows first in block order (a stable sort), and each shard's live
    count (n_local,)."""
    WR, n = rec.shape[1], rec.shape[2]
    live = rec[:, 0] != -1
    order = torch.where(live, torch.arange(n, device=rec.device), INVALID)
    perm = torch.sort(order, dim=1, stable=True).indices
    return (torch.gather(rec, 2, perm[:, None, :].expand(-1, WR, -1)),
            live.sum(1))


def _append_sorted(skl: sklstore.SklState, srt: torch.Tensor,
                   n_live: torch.Tensor) -> sklstore.SklState:
    """Write each local shard's live-first block srt (n_local, 2+nw, n)
    whole at the shard's n_rows, in place, and advance n_rows by its live
    count n_live (n_local,), so the next block overwrites the dead tail.
    Caller guarantees n_rows + n <= rcap on every shard."""
    WR, n = srt.shape[1], srt.shape[2]
    idx = skl.n_rows[:, None] + torch.arange(n, device=srt.device)
    skl.bucket.scatter_(1, idx, srt[:, 0])
    skl.meta.scatter_(1, idx, srt[:, 1])
    skl.nucs.scatter_(2, idx[:, None, :].expand(-1, WR - 2, -1), srt[:, 2:])
    return skl._replace(n_rows=skl.n_rows + n_live)


def _append_live_first(skl: sklstore.SklState, rec: torch.Tensor
                       ) -> sklstore.SklState:
    """Dense-append each local shard's row block rec (n_local, 2+nw, n)
    int32 in place: _live_first, then _append_sorted."""
    return _append_sorted(skl, *_live_first(rec))


def append_blocks(skl: sklstore.SklState, blocks: torch.Tensor,
                  n_live: torch.Tensor) -> sklstore.SklState:
    """Append a step's S live-first blocks (S, n_local, 2+nw, n) with
    their live counts (S, n_local) in step order, one _append_sorted
    each. Caller guarantees n_rows + S*n <= rcap on every shard."""
    for i in range(blocks.shape[0]):
        skl = _append_sorted(skl, blocks[i], n_live[i])
    return skl


def sharded_flush_body(codes: torch.Tensor, valid_start: torch.Tensor,
                       valid_end: torch.Tensor, chain, k: int, m: int,
                       b: int, mesh: Mesh, row_cap: int,
                       skl_route_cap: int):
    """Everything sharded_insert_windows_sklonly does but touch the
    arenas: per step, enumerate every local lane, certify (the
    cross-shard equality chain), segment into super-k-mer rows, route
    rows to their owner shard and exchange them, lay each shard's block
    out as [received rows in source order, then its own spilled rows]
    and sort it live-first. Returns (blocks (S, n_local, 2+nw, n)
    int32, n_live (S, n_local), n_sk, n_km, n_spilled_rows (global sums,
    device scalars), cert (S, B) bool, ends (MinimizerState of (S, B)
    leaves), skl_overflow (S, B) bool, chain'), n = n_shards *
    skl_route_cap + B_local * row_cap. On a one-process mesh a pure
    function of its inputs: flush_graph captures it."""
    S, B, L_buf = codes.shape
    n_shards, n_local = mesh.n_shards, mesh.n_local
    R = (B // n_local) * row_cap
    margin = k - 1
    dev = codes.device
    nw = sklstore.skl_dims(k, m, b)[3]
    fresh = torch.ones(B, dtype=torch.bool, device=dev)
    zero = enum_ops.zero_carry(B, dev)
    pos_out = torch.arange(margin, L_buf, device=dev)[None, :]
    spill_fill = torch.zeros((1, 2 + nw, 1), dtype=torch.int32, device=dev)
    spill_fill[0, 0] = -1
    n_sk = torch.zeros((), dtype=torch.int64, device=dev)
    n_km = torch.zeros((), dtype=torch.int64, device=dev)
    n_sp = torch.zeros((), dtype=torch.int64, device=dev)
    blocks, lives, certs, ends, ovfs = [], [], [], [], []
    for i in range(S):
        vs_i, ve_i = valid_start[i], valid_end[i]
        em, end = enum_ops.enumerate_batch(codes[i], fresh, ve_i, zero,
                                           k, m, b, valid_start=vs_i)
        exact, chain = _chain_exact_sharded(em, end, vs_i, chain, margin,
                                            mesh)
        ok2 = em.valid & exact[:, None]
        first_valid = pos_out == vs_i[:, None]
        rb, rm, rn, ovf = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, ok2, first_valid,
            em.boundary, k, m, b, row_cap)
        # (n_local, 2+nw, R) row records of each source shard's lanes
        rowrec = to_i32(torch.cat(
            [rb.reshape(n_local, 1, R), rm.reshape(n_local, 1, R),
             rn.reshape(nw, n_local, R).transpose(0, 1)], dim=1))
        live = rowrec[:, 0] != -1
        buf, routed = _route_local(rowrec, rowrec[:, 0], live, n_shards,
                                   skl_route_cap)
        rcv = multihost.exchange(buf, mesh).transpose(1, 2)
        spilled = live & ~routed
        spill_rows = torch.where(spilled[:, None, :], rowrec, spill_fill)
        srt, n_live = _live_first(torch.cat([rcv, spill_rows], dim=2))
        blocks.append(srt)
        lives.append(n_live)
        n_sk = n_sk + (em.boundary & ok2).sum()
        n_km = n_km + ok2.sum()
        n_sp = n_sp + spilled.sum()
        certs.append(exact)
        ends.append(end)
        ovfs.append(ovf)
    ends = MinimizerState(*(torch.stack(f) for f in zip(*ends)))
    return (torch.stack(blocks), torch.stack(lives),
            multihost.psum(n_sk, mesh), multihost.psum(n_km, mesh),
            multihost.psum(n_sp, mesh), torch.stack(certs), ends,
            torch.stack(ovfs), chain)


def sharded_insert_windows_sklonly(skl: sklstore.SklState,
                                   codes: torch.Tensor,
                                   valid_start: torch.Tensor,
                                   valid_end: torch.Tensor,
                                   chain, k: int, m: int, b: int,
                                   mesh: Mesh, row_cap: int,
                                   skl_route_cap: int):
    """THE sharded insert program: a stack of window batches (io.windows)
    into the per-shard arenas. codes (S, B, L_buf) 2-bit codes of this
    process's B = n_local*B_local lanes; valid_start, valid_end (S, B).
    sharded_flush_body, then append_blocks: each step's live-first block
    written at each shard's n_rows, in step order.

    Returns (skl', n_sk, n_km, n_spilled_rows (global sums, device
    scalars), cert (S, B) bool, ends (MinimizerState of (S, B) leaves),
    skl_overflow (S, B) bool, chain'). Capacity contract: per shard and
    per step the arena absorbs <= n_shards*skl_route_cap +
    B_local*row_cap rows. On the card, flush_graph.insert_sharded runs
    the same program as one CUDA graph replay on a one-process mesh."""
    blocks, n_live, *rest = sharded_flush_body(
        codes, valid_start, valid_end, chain, k, m, b, mesh, row_cap,
        skl_route_cap)
    return (append_blocks(skl, blocks, n_live), *rest)


def sharded_append_skl_rows(skl: sklstore.SklState, buf: torch.Tensor,
                            mesh: Mesh) -> sklstore.SklState:
    """Append a HOST-built row buffer: buf (n_local, cap_r, 2+nw) int32,
    INVALID-bucket padded; local shard s dense-appends buf[s]'s live
    rows (repaired-window and overflow-lane deliveries)."""
    assert buf.shape[0] == mesh.n_local
    return _append_live_first(skl, buf.transpose(1, 2))


def sharded_skl_empty(n_shards: int, row_cap: int, kmer_cap: int,
                      nw: int, mesh: Mesh) -> sklstore.SklState:
    """Empty arenas for this process's shards of an n_shards mesh."""
    assert n_shards == mesh.n_shards
    n, dev = mesh.n_local, mesh.device
    z = torch.zeros(n, dtype=torch.int64, device=dev)
    return sklstore.SklState(
        bucket=torch.full((n, row_cap), -1, dtype=torch.int32, device=dev),
        meta=torch.zeros((n, row_cap), dtype=torch.int32, device=dev),
        nucs=torch.zeros((n, nw, row_cap), dtype=torch.int32, device=dev),
        data=torch.zeros((n, kmer_cap), dtype=torch.int32, device=dev),
        offs=torch.zeros((n, row_cap), dtype=torch.int32, device=dev),
        n_rows=z, n_fin_rows=z.clone(), n_fin_kmers=z.clone())


def sharded_skl_grow(skl: sklstore.SklState, row_cap: int, mesh: Mesh
                     ) -> sklstore.SklState:
    """Per-shard row-capacity growth (pads the row axis; `data` keeps its
    size)."""
    pad = row_cap - skl.bucket.shape[1]
    assert pad >= 0

    def padded(x, value=0):
        tail = torch.full(x.shape[:-1] + (pad,), value, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail], dim=-1)

    return skl._replace(bucket=padded(skl.bucket, -1),
                        meta=padded(skl.meta), nucs=padded(skl.nucs),
                        offs=padded(skl.offs))
