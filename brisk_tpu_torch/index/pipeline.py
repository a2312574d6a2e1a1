"""The insert programs (port of brisk_tpu.index.pipeline: the k <= 32
flat windowed program and the k > 32 streaming program).

k <= 32: one flush ships ONE contiguous packed chunk; the overlapping
window lanes are built on the device by reshape/concat (no gather), each
batch of the stack is enumerated, certified, segmented into compacted
super-k-mer rows and appended densely to the arena at the device row
offset — no host read inside a flush.

k > 32: one record per lane with the exact minimizer carry across
batches (insert_stream_sklnative); the same row segmentation and dense
append.

Each of the two is a pure body that touches no arena (flat_flush_body,
stream_flush_body: the S batches' live-first row blocks, flags, counts
and chain or carry) followed by append_blocks, S appends in batch order.
On the card index.flush_graph captures each body once per geometry and
replays it once a flush, as brisk_tpu's jit runs each program as one
dispatch.

Generic payloads: insert_windows_payload runs the windowed enumeration
and certificate into an index.payload state, one (count, position)
column per emission: payload_flush_body (the S batches' tombstoned key
and lane columns) followed by one payload.append_masked, which
flush_graph captures and replays the same way.
"""

from typing import NamedTuple, Tuple

import torch

from brisk_tpu_torch._u32 import INVALID, M32, to_i32
from brisk_tpu_torch.index import payload, sklstore, store
from brisk_tpu_torch.ops import enumerate as enum_ops
from brisk_tpu_torch.ops.minimizer import MinimizerState


def zero_chain(device="cpu"):
    """Initial window-continuity chain carry: (predecessor end state of
    the LAST lane processed so far — MinimizerState of 0-dim tensors —
    and whether that state is exact)."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    f = torch.zeros((), dtype=torch.bool, device=device)
    return MinimizerState(z, z, z, f, z, z, z), f


def _chain_exact(em, end: MinimizerState, vs_i: torch.Tensor, chain,
                 margin: int):
    """End-state EQUALITY certificate chained across lanes: lane j is
    exact iff em.cert holds (u_j), or its replayed state at valid_start-1
    equals lane j-1's end state (q_j) and lane j-1 is exact:

        exact_j = u_j | (q_j & exact_{j-1}),  exact_{-1} = prev_exact.

    With a = the last index <= j where u holds and c = the last index
    <= j where q fails (-1 if none), exact_j = (a >= max(c, 0)) |
    (c < 0 & prev_exact): two cummax passes, no loop over lanes.
    Returns (exact (B,) bool, new_chain)."""
    prev_end, prev_exact = chain
    pred = MinimizerState(*(torch.cat([c.reshape(1).to(e.dtype), e[:-1]])
                            for c, e in zip(prev_end, end)))
    eq = torch.ones_like(em.cert)
    for a, p in zip(em.replay, pred):
        eq = eq & (a == p)
    u = em.cert
    q = eq & (vs_i != margin)  # window-0 lanes certify via u alone
    idx = torch.arange(u.shape[0], device=u.device)
    a = torch.cummax(torch.where(u, idx, -1), 0).values
    c = torch.cummax(torch.where(q, -1, idx), 0).values
    exact = ((a >= c) & (a >= 0)) | ((c < 0) & prev_exact)
    new_chain = (MinimizerState(*(e[-1] for e in end)), exact[-1])
    return exact, new_chain


def _unpack4_device(codes4: torch.Tensor, l_buf: int) -> torch.Tensor:
    """Packed (B, L4) uint8 (4 bases/byte, first base in the low bits)
    -> (B, l_buf) int64 2-bit codes."""
    c = codes4.to(torch.int64)
    un = torch.stack([c & 3, (c >> 2) & 3, (c >> 4) & 3, (c >> 6) & 3],
                     dim=-1)
    return un.reshape(c.shape[0], -1)[:, :l_buf]


class Blocks(NamedTuple):
    """One flush's S live-first row blocks (int32 u32 bit patterns), R =
    B * row_cap rows each: batch i's live rows first in genome order,
    then its dead tail."""
    bucket: torch.Tensor  # (S, R)
    meta: torch.Tensor    # (S, R)
    nucs: torch.Tensor    # (S, NW, R)


def _live_first(rb, rm, rn, iota: torch.Tensor):
    """One batch's rows (rows_from_emissions) -> its block (bucket (R,),
    meta (R,), nucs (NW, R) int32, live rows first, genome order kept
    by a stable sort) and its live count."""
    R = iota.shape[0]
    rb_f = rb.reshape(R)
    live = rb_f != INVALID
    order = torch.sort(torch.where(live, iota, INVALID), stable=True).indices
    return (to_i32(rb_f[order]), to_i32(rm.reshape(R)[order]),
            to_i32(rn.reshape(rn.shape[0], R)[:, order]), live.sum())


def _stack_blocks(blocks: list) -> Tuple[Blocks, torch.Tensor]:
    """[(bucket, meta, nucs, n_live)] of S batches -> (Blocks, n_live
    (S,) int64)."""
    b, m, n, live = zip(*blocks)
    return (Blocks(torch.stack(b), torch.stack(m), torch.stack(n)),
            torch.stack(live))


def append_blocks(skl, blocks: Blocks, n_live: torch.Tensor):
    """Append a flush's S blocks to the arena in batch order, one
    sklstore.append_n each: every block is written whole at the device
    row offset and n_rows advances by its live count, so the next block
    overwrites its dead tail (one scatter of all S blocks would write
    duplicate indices). Precondition: skl.n_rows + S*R <= rcap."""
    iota = torch.arange(blocks.bucket.shape[1], device=n_live.device)
    for i in range(n_live.shape[0]):
        skl = sklstore.append_n(skl, blocks.bucket[i], blocks.meta[i],
                                blocks.nucs[i], n_live[i], iota)
    return skl


def _window_scan_body(codes: torch.Tensor, valid_start: torch.Tensor,
                      valid_end: torch.Tensor, chain,
                      k: int, m: int, b: int, row_cap: int, l_buf: int):
    """Enumerate a stack of window batches into row blocks: codes (S, B,
    l_buf4) packed. Returns (Blocks, n_live (S,), flags (S, B) uint8
    [bit0 = certified, bit1 = skl row overflow], ends (MinimizerState of
    (S, B) leaves), n_sk, n_km, chain'). Touches no arena."""
    S, B, _ = codes.shape
    margin = k - 1
    dev = codes.device
    fresh = torch.ones(B, dtype=torch.bool, device=dev)
    zero = enum_ops.zero_carry(B, dev)
    pos_out = torch.arange(margin, l_buf, device=dev)[None, :]
    iota = torch.arange(B * row_cap, device=dev)
    n_sk = torch.zeros((), dtype=torch.int64, device=dev)
    n_km = torch.zeros((), dtype=torch.int64, device=dev)
    blocks, flags, ends = [], [], []
    for i in range(S):
        vs_i, ve_i = valid_start[i], valid_end[i]
        codes_i = _unpack4_device(codes[i], l_buf)
        em, end = enum_ops.enumerate_batch(codes_i, fresh, ve_i, zero,
                                           k, m, b, valid_start=vs_i)
        exact, chain = _chain_exact(em, end, vs_i, chain, margin)
        ok = em.valid & exact[:, None]
        first_valid = pos_out == vs_i[:, None]
        rb, rm, rn, ovf = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, ok,
            first_valid, em.boundary, k, m, b, row_cap)
        blocks.append(_live_first(rb, rm, rn, iota))
        n_sk = n_sk + (em.boundary & ok).sum()
        n_km = n_km + ok.sum()
        flags.append(exact.to(torch.uint8) | (ovf.to(torch.uint8) << 1))
        ends.append(end)
    ends = MinimizerState(*(torch.stack(f) for f in zip(*ends)))
    return (*_stack_blocks(blocks), torch.stack(flags), ends, n_sk, n_km,
            chain)


def flat_flush_body(chunk4: torch.Tensor, valid_start: torch.Tensor,
                    valid_end: torch.Tensor, chain, k: int, m: int, b: int,
                    row_cap: int, l_buf: int, useful: int):
    """Everything insert_flat_sklnative does but touch the arena: the
    window build, then S x (enumerate_batch, _chain_exact,
    rows_from_emissions, live-first sort). chunk4: ((S*B + ext) *
    useful4,) uint8 packed codes with window j of the flush at byte
    offset j*useful4 (io.windows.WindowPacker.pack_flat); valid_start,
    valid_end (S, B). The overlapping l_buf4-wide windows are `nparts`
    statically shifted row slices of the useful4-wide chunk rows,
    concatenated along the byte axis. Returns (Blocks, n_live (S,),
    flags, ends, n_sk, n_km, chain') as _window_scan_body. A pure
    function of its inputs: flush_graph captures it."""
    S, B = valid_start.shape
    SB = S * B
    u4 = useful // 4
    lb4 = -(-l_buf // 4)
    nparts = -(-lb4 // u4)
    rows = chunk4.reshape(SB + nparts - 1, u4)
    win4 = torch.cat([rows[s:s + SB] for s in range(nparts)], dim=1)[:, :lb4]
    codes = win4.reshape(S, B, lb4)
    return _window_scan_body(codes, valid_start, valid_end, chain,
                             k, m, b, row_cap, l_buf)


def insert_flat_sklnative(skl, chunk4: torch.Tensor,
                          valid_start: torch.Tensor,
                          valid_end: torch.Tensor, chain,
                          k: int, m: int, b: int,
                          row_cap: int, l_buf: int, useful: int):
    """THE product insert program (k <= 32): flat_flush_body, then
    append_blocks. Returns (skl', n_sk, n_km, flags (S, B) uint8 [bit0 =
    certified, bit1 = skl row overflow], ends (MinimizerState of (S, B)
    leaves), n_rows_after, chain'). Precondition: skl.n_rows + S*B*row_cap
    <= rcap. On the card, flush_graph.insert_flat runs the same program
    as one CUDA graph replay."""
    blocks, n_live, flags, ends, n_sk, n_km, chain = flat_flush_body(
        chunk4, valid_start, valid_end, chain, k, m, b, row_cap, l_buf,
        useful)
    skl = append_blocks(skl, blocks, n_live)
    return skl, n_sk, n_km, flags, ends, skl.n_rows.clone(), chain


def stream_flush_body(codes: torch.Tensor, fresh: torch.Tensor,
                      valid_end: torch.Tensor, carry: MinimizerState,
                      k: int, m: int, b: int, row_cap: int):
    """Everything insert_stream_sklnative does but touch the arena:
    S x (enumerate_batch with the carry, rows_from_emissions, live-first
    sort). Returns (Blocks, n_live (S,), n_sk, n_km, carry'). A pure
    function of its inputs: flush_graph captures it."""
    S, B, L_buf = codes.shape
    margin = k - 1
    dev = codes.device
    iota = torch.arange(B * row_cap, device=dev)
    first_valid = (torch.arange(margin, L_buf, device=dev) == margin
                   ).expand(B, L_buf - margin)
    n_sk = torch.zeros((), dtype=torch.int64, device=dev)
    n_km = torch.zeros((), dtype=torch.int64, device=dev)
    blocks = []
    for i in range(S):
        fresh_i, ve_i = fresh[i], valid_end[i]
        em, carry = enum_ops.enumerate_batch(codes[i], fresh_i, ve_i, carry,
                                             k, m, b)
        rb, rm, rn, _ = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, em.valid,
            first_valid, em.boundary, k, m, b, row_cap)
        blocks.append(_live_first(rb, rm, rn, iota))
        n_sk = n_sk + (em.boundary & em.valid).sum() + (fresh_i
                                                        & (ve_i > 0)).sum()
        n_km = n_km + em.valid.sum()
    return (*_stack_blocks(blocks), n_sk, n_km, carry)


def insert_stream_sklnative(skl, codes: torch.Tensor, fresh: torch.Tensor,
                            valid_end: torch.Tensor, carry: MinimizerState,
                            k: int, m: int, b: int, row_cap: int):
    """THE k > 32 insert program: one RECORD per lane with the exact
    streaming carry across batches and flushes, so it needs no
    certificate and repairs nothing. codes (S, B, L_buf) unpacked 2-bit
    codes; fresh, valid_end (S, B); carry a MinimizerState of (B,)
    leaves. Every lane's first valid emission starts a row (rows split
    at batch seams; content and counts are unaffected). n_sk adds one
    super-k-mer per fresh non-empty lane. stream_flush_body, then
    append_blocks. Returns (skl', n_sk, n_km, carry', n_rows_after).
    Precondition: skl.n_rows + S*B*row_cap <= rcap. On the card,
    flush_graph.insert_stream runs the same program as one CUDA graph
    replay."""
    blocks, n_live, n_sk, n_km, carry = stream_flush_body(
        codes, fresh, valid_end, carry, k, m, b, row_cap)
    skl = append_blocks(skl, blocks, n_live)
    return skl, n_sk, n_km, carry, skl.n_rows.clone()


def payload_flush_body(codes: torch.Tensor, valid_start: torch.Tensor,
                       valid_end: torch.Tensor, pos0: torch.Tensor, chain,
                       k: int, m: int, b: int, width: int):
    """Everything insert_windows_payload does but touch the state:
    S x (enumerate_batch, _chain_exact, store.make_keys, the lanes).
    Returns (keys (W, S*N) int32, lanes (width, S*N) int32, n_km, cert
    (S, B) bool, ends (MinimizerState of (S, B) leaves), chain'), N =
    B * (L_buf - k + 1): batch i's columns at [i*N, (i+1)*N), already
    tombstoned (an invalid column holds INVALID in every key word and 0
    in every lane). A pure function of its inputs: flush_graph captures
    it."""
    S, B, L_buf = codes.shape
    margin = k - 1
    dev = codes.device
    fresh = torch.ones(B, dtype=torch.bool, device=dev)
    zero = enum_ops.zero_carry(B, dev)
    rel = torch.arange(L_buf - margin, device=dev)[None, :]
    n_km = torch.zeros((), dtype=torch.int64, device=dev)
    keys, lanes, certs, ends = [], [], [], []
    for i in range(S):
        vs_i = valid_start[i]
        em, end = enum_ops.enumerate_batch(codes[i], fresh, valid_end[i],
                                           zero, k, m, b, valid_start=vs_i)
        exact, chain = _chain_exact(em, end, vs_i, chain, margin)
        rows = store.make_keys(em.bucket.reshape(-1), em.key.reshape(4, -1),
                               em.mini_idx.reshape(-1), k, b)
        valid = (em.valid & exact[:, None]).reshape(-1)
        pos = ((pos0[i].to(torch.int64)[:, None] + rel) & M32).reshape(-1)
        vals = torch.stack([torch.ones_like(pos)] + [pos] * (width - 1))
        keys.append(torch.where(valid[None, :], to_i32(rows), -1))
        lanes.append(torch.where(valid[None, :], to_i32(vals), 0))
        n_km = n_km + valid.sum()
        certs.append(exact)
        ends.append(end)
    ends = MinimizerState(*(torch.stack(f) for f in zip(*ends)))
    return (torch.cat(keys, dim=1), torch.cat(lanes, dim=1), n_km,
            torch.stack(certs), ends, chain)


def insert_windows_payload(state, codes: torch.Tensor,
                           valid_start: torch.Tensor,
                           valid_end: torch.Tensor, pos0: torch.Tensor,
                           chain, k: int, m: int, b: int, width: int):
    """Sequence-parallel windowed insert into a generic payload state
    (index.payload): per certified emission, lane 0 gets 1 (count) and
    lanes 1.. get the k-mer's record position pos0[lane] + (p - margin),
    masked to 32 bits; payload.compact's lane kinds merge them.

    codes (S, B, L_buf) unpacked 2-bit codes; valid_start, valid_end and
    pos0 (S, B), pos0 each window's first k-mer index within its record
    (win * useful). The same window-continuity chain as the sklnative
    insert. payload_flush_body, then one payload.append_masked of its S*N
    columns at n_used (the same columns as S appends of N in batch
    order: each advances n_used by N, tombstones included). Returns
    (state', n_km, cert (S, B) bool, ends (MinimizerState of (S, B)
    leaves), chain'). Precondition: state.n_used + S*B*(L_buf - k + 1)
    <= capacity. On the card, flush_graph.insert_payload runs the same
    program as one CUDA graph replay."""
    keys, lanes, n_km, cert, ends, chain = payload_flush_body(
        codes, valid_start, valid_end, pos0, chain, k, m, b, width)
    return payload.append_masked(state, keys, lanes), n_km, cert, ends, chain
