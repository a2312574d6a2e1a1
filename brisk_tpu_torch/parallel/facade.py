"""ShardedBrisk — the sharded user facade (port of
brisk_tpu.parallel.facade).

The single-device `api.Brisk` over a shard axis (parallel.multihost.Mesh):
record lanes are data-parallel across shards, the index is sharded by
reduced minimizer (bucket % n_shards), and super-k-mer rows ride a
capacity-bounded all-to-all to their owner shard with skew overflow
spilling to the source shard (parallel.sharded). In one process every
shard lives on one device (8 shards on one card, or on the CPU);
across processes each process holds a contiguous block of shards
(`torch.distributed`: gloo on the CPU, nccl on cards).

Insertion (every k) uses the windowed path: records are split into
overlapping windows (io.windows) across ALL lanes, a stack of S window
batches runs through sharded.sharded_insert_windows_sklonly, and the
rare uncertified windows are re-run exactly through the streaming carry
path and delivered to the shards through a host-built row buffer
(sharded.sharded_append_skl_rows). In one process on a CUDA card each
step is one CUDA graph replay of that program
(flush_graph.insert_sharded: the step's body captured at the geometry's
first flush, the arenas' appends after it); the repairs run eagerly.
Across processes the step runs eagerly: its collectives go through
torch.distributed (the cross-shard chain's gathers, all_to_all_single,
all_reduce), which the graph runner does not capture, since NCCL across
several cards has never run. At k > 32 the truncation quirk starves
the certificate and the batched repairs keep counts exact.

Capacity contracts are HOST-enforced: appends consume a fixed number of
row slots per step, tracked on the host as an upper bound, so the hot
loop never reads n_rows back; growth happens only when the bound nears
capacity.
"""

import functools
import glob
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from brisk_tpu_torch import _u32, spans
from brisk_tpu_torch.index import (flush_graph, pipeline, readout, sklstore,
                                   store)
from brisk_tpu_torch.io import fasta, windows
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.ops import enumerate as enum_ops
from brisk_tpu_torch.params import Parameters
from brisk_tpu_torch.parallel import multihost, sharded

U32 = np.uint32
_INVALID = U32(0xFFFFFFFF)
# Logical shards when neither a mesh nor n_devices is given (brisk_tpu
# defaults to its device count, 8 on its test mesh)
DEFAULT_SHARDS = 8


class ShardedBrisk:
    """Dynamic k-mer -> count index sharded over a shard axis.

    device: where this process's shards live, the first CUDA card unless
    given ("cpu"); without a card a CUDA device raises. `route_cap` and
    `capacity` (brisk_tpu's per-k-mer store) are unused and kept for
    signature parity with brisk_tpu."""

    def __init__(self, params: Parameters, mesh=None, n_devices: int = None,
                 batch_per_shard: int = 64, window: int = 256,
                 stack: int = 4, route_cap: int = None,
                 skl_route_cap: int = None, capacity: int = 1 << 16,
                 device="cuda"):
        from brisk_tpu_torch.api import _device
        if mesh is None:
            dev = _device(device)
            n = n_devices or DEFAULT_SHARDS
            if multihost.process_count() > 1:
                mesh = multihost.global_mesh(n, dev)
            else:
                mesh = sharded.make_mesh(n, dev)
        else:
            _device(mesh.device)
        self.mesh = mesh
        self.device = mesh.device
        self.params = params
        self.n_shards = mesh.n_shards
        self.B_local = batch_per_shard
        self.B = self.n_shards * batch_per_shard
        # large (k - m) warm-ups bump small windows (see api.Brisk)
        wu = windows.default_warmup(params.k, params.m)
        self.window = max(window, -(-(wu + 48) // 16) * 16)
        self.stack = stack
        # host-major shard blocks: each process packs ONLY its own
        # records into its own shards' lanes
        self.n_proc = mesh.n_proc
        self.multihost = self.n_proc > 1
        self.pid = mesh.pid
        self.my_shards = list(mesh.my_shards)
        self.my_lanes = len(self.my_shards) * batch_per_shard  # B in one
        self.n_emitted = 0      # GLOBAL windowed emissions + MY repairs
        self.n_superkmers = 0
        self.n_spilled = 0
        self.n_repaired_windows = 0
        self.n_skl_overflows = 0
        # repair contributions are per-process (stats() sums them across
        # processes; the windowed parts are already global sums)
        self._repair_emitted = 0
        self._repair_superkmers = 0
        self.skl = None
        self._skl_dirty = False
        self._skl_rows_ub = 0   # upper bound on max-shard skl n_rows
        self._skl_segments = {}  # shard -> [(lo, hi)] bucket-grouped runs
        self._bucket_cols = {}   # shard -> host copy of its bucket column
        # from the bumped window, as in brisk_tpu's facade
        self.skl_row_cap = max(16, self.window // 4)
        # multinomial sizing: 4x the mean per-destination traffic; the
        # skewed tail spills to the source shard
        self.skl_route_cap = skl_route_cap or max(
            16, 4 * batch_per_shard * self.skl_row_cap // self.n_shards)
        _, _, _, nw = sklstore.skl_dims(params.k, params.m, params.b)
        self._skl_nw = nw
        per_flush = stack * (self.n_shards * self.skl_route_cap
                             + batch_per_shard * self.skl_row_cap)
        rcap = 1 << max(12, (2 * per_flush - 1).bit_length())
        self.skl = sharded.sharded_skl_empty(self.n_shards, rcap, 1 << 12,
                                             nw, mesh)

    # -- capacity (host-enforced; see the sharded insert contract) ---------

    def _ensure_skl_room(self, rows_per_shard: int) -> None:
        rcap = self.skl.bucket.shape[1]
        if self._skl_rows_ub + rows_per_shard <= rcap:
            return
        self._skl_rows_ub = multihost.process_max(
            int(self.skl.n_rows.max()), self.mesh)
        target = rcap
        while self._skl_rows_ub + rows_per_shard > target:
            target *= 2
        if target != rcap:
            self.skl = sharded.sharded_skl_grow(self.skl, target, self.mesh)

    # -- insertion ---------------------------------------------------------

    def insert_file(self, path: str) -> None:
        from brisk_tpu_torch import native
        with spans.call("insert_file"):
            with spans.span("parse"):
                parsed = native.parse_fasta_buffer(path)
                if parsed is None:  # no native lib: the Python parser
                    parsed = windows.code_buffer(
                        pyref.read_fasta_chunks(path))
            self._insert_codes(*parsed)

    def insert_sequence(self, seq: str) -> None:
        # one record: process 0's across processes
        self._insert_codes(*windows.code_buffer([seq]))

    def _insert_codes(self, codes: np.ndarray, offs: np.ndarray) -> None:
        """Insert the records of one code buffer (record i at
        codes[offs[i]:offs[i + 1]]): one window table of them, then each
        stack of window batches gathered from the buffer (io.windows
        pack_stacks) and flushed. Across processes each process takes
        every n_proc-th record (every process reads the shared file),
        the flush count is synchronized (process_max), and a process
        that runs out of data pads with empty stacks, so the collectives
        run in lockstep."""
        p = self.params
        packer = windows.WindowPacker(p.k, p.m, self.my_lanes,
                                      l_out=self.window)
        S = self.stack
        with spans.span("pack"):
            starts, lengths = offs[:-1], np.diff(offs)
            if self.multihost:
                mine = np.arange(len(starts)) % self.n_proc == self.pid
                starts, lengths = starts[mine], lengths[mine]
            table = packer.window_table(starts, lengths)
        n_stacks = 0
        if self.multihost:
            n_stacks = multihost.process_max(
                -(-len(table.start) // (S * self.my_lanes)), self.mesh)
        self._prev_tail = None
        self._chain = pipeline.zero_chain(self.device)
        for st in spans.iterate("pack", packer.pack_stacks(codes, table, S,
                                                           n_stacks)):
            self._flush_stack(packer, st)

    def _stage(self, st: windows.WinStack) -> tuple:
        """A stack's inputs of the sharded step on the device: (codes (S,
        B, L_buf), valid_start, valid_end)."""
        return tuple(torch.from_numpy(x).to(self.device)
                     for x in (st.codes, st.valid_start, st.valid_end))

    def _flush_stack(self, packer, st: windows.WinStack) -> None:
        p = self.params
        batches = st.batches
        S = len(batches)
        B = self.my_lanes
        per_flush = S * (self.n_shards * self.skl_route_cap
                         + self.B_local * self.skl_row_cap)
        self._ensure_skl_room(per_flush)
        # one graph replay a step on a one-process mesh on the card; a
        # mesh of several processes runs the eager program (its
        # collectives are not captured)
        step = (flush_graph.insert_sharded if self.mesh.group is None
                else sharded.sharded_insert_windows_sklonly)
        with spans.span("pack"):
            staged = self._stage(st)
        with spans.span("flush"):
            (self.skl, n_sk, n_km, n_sp, cert, ends, ovf,
             self._chain) = step(
                self.skl, *staged, self._chain,
                p.k, p.m, p.b, self.mesh, self.skl_row_cap,
                self.skl_route_cap)
        self._skl_rows_ub += per_flush
        self._skl_dirty = True
        # ONE device->host copy: counters, certificates, overflow flags
        # and the per-lane end states
        with spans.span("readback"):
            host = torch.cat([torch.stack([n_sk, n_km, n_sp]),
                              cert.reshape(-1).to(torch.int64),
                              ovf.reshape(-1).to(torch.int64)]
                             + [e.reshape(-1).to(torch.int64) for e in ends]
                             ).cpu().numpy()
        n_sk, n_km, n_sp = (int(x) for x in host[:3])
        self.n_emitted += n_km
        self.n_spilled += n_sp
        self.n_superkmers += n_sk + sum(bt.n_records for bt in batches)
        SB = S * B
        cert_f = host[3:3 + SB].astype(bool)
        ovf_f = host[3 + SB:3 + 2 * SB].astype(bool)
        ends_f = [host[3 + (2 + f) * SB:3 + (3 + f) * SB] for f in range(7)]
        ends_f[3] = ends_f[3].astype(bool)

        # exact repair of uncertified windows: consecutive failures form
        # contiguous genome runs, each re-run as ONE streaming lane;
        # independent runs batch across lanes (api.Brisk._repair_runs).
        # Across processes each process repairs its own lanes (records
        # never span processes)
        rec_f = np.concatenate([bt.rec for bt in batches])
        win_f = np.concatenate([bt.win for bt in batches])
        failed = np.nonzero((~cert_f) & (rec_f >= 0))[0]
        repaired_ends = {}

        def end_of(j):
            if j in repaired_ends:
                return repaired_ends[j]
            return tuple(e[j] for e in ends_f)

        for j in failed:
            r, w = int(rec_f[j]), int(win_f[j])
            assert w > 0, "window 0 is always certified"
            if j == 0:
                assert self._prev_tail[:2] == (r, w - 1), \
                    "stack continuity broken"
            else:
                assert rec_f[j - 1] == r and win_f[j - 1] == w - 1
        MAX_RUN = 64
        runs = []
        for j in (int(x) for x in failed):
            if runs and runs[-1][-1] == j - 1 and len(runs[-1]) < MAX_RUN:
                runs[-1].append(j)
            else:
                runs.append([j])
        repaired_skl = []
        while runs:
            blocked = {j for rr in runs for j in rr}
            ready = [r for r in runs if r[0] - 1 not in blocked]
            rest = [r for r in runs if r[0] - 1 in blocked]
            carries = [self._prev_tail[2] if r[0] == 0 else end_of(r[0] - 1)
                       for r in ready]
            with spans.span("repair"):
                end7s, sklrows_np = self._rerun_runs(packer, batches, ready,
                                                     carries)
            for r, e7 in zip(ready, end7s):
                repaired_ends[r[-1]] = e7
            if sklrows_np is not None:
                repaired_skl.append(sklrows_np)
            self.n_repaired_windows += sum(len(r) for r in ready)
            runs = rest

        live = np.nonzero(rec_f >= 0)[0]
        if len(live):
            j = int(live[-1])
            self._prev_tail = (int(rec_f[j]), int(win_f[j]), end_of(j))

        # skl-overflow lanes (certified, but > row_cap segments): rebuild
        # their rows at full width and deliver them with the repairs
        ovf_lanes = np.nonzero(ovf_f & cert_f & (rec_f >= 0))[0]
        if len(ovf_lanes):
            repaired_skl.append(
                self._rebuild_overflow_rows(packer, batches, ovf_lanes))
            self.n_skl_overflows += len(ovf_lanes)

        skl_all = (np.concatenate(repaired_skl, axis=0) if repaired_skl
                   else np.zeros((0, 2 + self._skl_nw), dtype=U32))
        if self.multihost or len(skl_all):
            # collective delivery every flush across processes (peers
            # call in lockstep even with no local repairs)
            self._deliver_skl_rows(skl_all)

    def _rerun_runs(self, packer, batches, runs, carries):
        """Exact streaming re-run of runs of consecutive failed windows
        (one contiguous genome span per run, one lane per run, one call
        per pass — see api.Brisk._repair_runs). Returns (end 7-tuple per
        run's LAST window, skl row records (N, 2+nw))."""
        from brisk_tpu_torch.api import end_states
        p = self.params
        warmup, useful, l_buf = packer.warmup, packer.useful, packer.l_buf
        B = batches[0].codes.shape[0]  # local lane count
        R = len(runs)
        Rp = 1 << max(2, (R - 1).bit_length())
        span_max = 1 << (max(len(r) for r in runs) - 1).bit_length()
        L_rep = (l_buf - warmup) + (span_max - 1) * useful
        codes = np.zeros((Rp, L_rep), dtype=np.uint8)
        ve = np.zeros(Rp, dtype=np.int64)
        carry_np = [np.zeros(Rp, dtype=bool if f == 3 else np.int64)
                    for f in range(7)]
        for i, (run, c7) in enumerate(zip(runs, carries)):
            s0, lane0 = divmod(run[0], B)
            pos = l_buf - warmup
            codes[i, :pos] = batches[s0].codes[lane0][warmup:]
            for j in run[1:]:
                s, lane = divmod(j, B)
                codes[i, pos:pos + useful] = \
                    batches[s].codes[lane][l_buf - useful:]
                pos += useful
            s_l, lane_l = divmod(run[-1], B)
            ve[i] = (len(run) - 1) * useful + \
                int(batches[s_l].valid_end[lane_l]) - warmup
            for f in range(7):
                carry_np[f][i] = c7[f]
        dev = self.device
        carry = enum_ops.MinimizerState(
            *(torch.from_numpy(x).to(dev) for x in carry_np))
        em, _ = enum_ops.enumerate_batch(
            torch.from_numpy(codes).to(dev),
            torch.zeros(Rp, dtype=torch.bool, device=dev),
            torch.from_numpy(ve).to(dev), carry, p.k, p.m, p.b)
        sklrows_np = self._skl_rows_np(em, em.valid)
        n_valid = int(em.valid.sum())
        n_sk = int((em.boundary & em.valid).sum())
        self.n_emitted += n_valid
        self.n_superkmers += n_sk
        self._repair_emitted += n_valid
        self._repair_superkmers += n_sk
        return end_states(em, ve, range(R), p.k, p.m), sklrows_np

    def _skl_rows_np(self, em, valid) -> np.ndarray:
        """Full-width skl row assembly for repair/overflow emissions ->
        host (N, 2+nw) uint32 live row records (the first emission of each
        lane starts a segment)."""
        p = self.params
        L_out = valid.shape[1]
        lanes = torch.nonzero(valid.any(1))[:, 0]
        first_valid = torch.zeros_like(valid)
        first_valid[lanes, valid.to(torch.int8).argmax(1)[lanes]] = True
        rb, rm, rn, ovf = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, valid, first_valid,
            em.boundary, p.k, p.m, p.b, L_out)
        assert not bool(ovf.any())
        rb_f = _u32.to_np(rb.reshape(-1))
        live = rb_f != _INVALID
        rm_f = _u32.to_np(rm.reshape(-1))[live]
        rn_f = _u32.to_np(rn.reshape(rn.shape[0], -1))[:, live]
        return np.concatenate([rb_f[live][None], rm_f[None], rn_f],
                              axis=0).T.astype(U32)

    def _rebuild_overflow_rows(self, packer, batches, lanes) -> np.ndarray:
        """Re-run certified skl-overflow lanes at full width (their k-mers
        were counted by the windowed program; only their rows were
        withheld). One enumeration over all such lanes."""
        p = self.params
        B = batches[0].codes.shape[0]
        R = len(lanes)
        Rp = 1 << max(2, (R - 1).bit_length())
        codes = np.zeros((Rp, packer.l_buf), dtype=np.uint8)
        vs = np.zeros(Rp, dtype=np.int64)
        ve = np.zeros(Rp, dtype=np.int64)
        for i, j in enumerate(int(x) for x in lanes):
            s, lane = divmod(j, B)
            codes[i] = batches[s].codes[lane]
            vs[i] = int(batches[s].valid_start[lane])
            ve[i] = int(batches[s].valid_end[lane])
        dev = self.device
        em, _ = enum_ops.enumerate_batch(
            torch.from_numpy(codes).to(dev),
            torch.ones(Rp, dtype=torch.bool, device=dev),
            torch.from_numpy(ve).to(dev), enum_ops.zero_carry(Rp, dev),
            p.k, p.m, p.b, valid_start=torch.from_numpy(vs).to(dev))
        return self._skl_rows_np(em, em.valid)

    def _deliver_skl_rows(self, rows_np: np.ndarray) -> None:
        """Deliver host-built skl row records (N, 2+nw) to shards: routed
        by bucket ownership in one process, spilled to this process's own
        shards across processes (collective; lockstep)."""
        with spans.span("deliver"):
            WR = 2 + self._skl_nw
            if self.multihost:
                if multihost.process_max(len(rows_np), self.mesh) == 0:
                    return
                n_mine = len(self.my_shards)
                cap_r = multihost.process_max(
                    -(-max(len(rows_np), 1) // n_mine), self.mesh)
                host_buf = np.zeros((n_mine, cap_r, WR), dtype=U32)
                host_buf[:, :, 0] = _INVALID
                for i in range(n_mine):
                    rd = rows_np[i * cap_r:(i + 1) * cap_r]
                    host_buf[i, :len(rd)] = rd
            else:
                dest = rows_np[:, 0] % U32(self.n_shards)
                cap_r = max(int(np.bincount(
                    dest, minlength=self.n_shards).max()), 1)
                host_buf = np.zeros((self.n_shards, cap_r, WR), dtype=U32)
                host_buf[:, :, 0] = _INVALID
                for d in range(self.n_shards):
                    rd = rows_np[dest == d]
                    host_buf[d, :len(rd)] = rd
            self._ensure_skl_room(cap_r)
            self.skl = sharded.sharded_append_skl_rows(
                self.skl, _u32.from_np(host_buf, self.device), self.mesh)
            self._skl_rows_ub += cap_r
            self._skl_dirty = True

    # -- lookup ------------------------------------------------------------

    def get(self, kmer: str) -> Optional[int]:
        """Count of one k-mer (orientation-sensitive, like api.Brisk.get /
        Brisk::get, Brisk.hpp:63-69), summed across shards: every local
        shard's bucket slice is probed, so spill placement (a key living
        off its owner shard) is invisible."""
        from brisk_tpu_torch.index import keying
        p = self.params
        if len(kmer) != p.k:
            raise ValueError(f"need a {p.k}-mer, got {len(kmer)} bases")
        self.finalize()
        buckets, cols = keying.key_batch(
            keying.strs_to_codes([kmer]), p.m, p.b)
        bucket = int(buckets[0])
        total = 0
        found_any = False
        for d, lskl in self._local_skl():
            if d not in self._bucket_cols:
                self._bucket_cols[d] = sklstore.fetch_rows(
                    lskl.bucket, 0, int(lskl.n_fin_rows))
            found, vals = sklstore.probe(
                lskl, cols, bucket, p.k, p.m, p.b,
                segments=self._skl_segments.get(d),
                bucket_col=self._bucket_cols[d])
            if bool(found[0]):
                found_any = True
                total += int(vals[0])
        if self.multihost:
            total = multihost.process_sum(total, self.mesh)
            found_any = multihost.process_sum(int(found_any), self.mesh) > 0
        if found_any:
            return total % 256
        return None

    def get_canonical(self, kmer: str) -> Optional[int]:
        c = self.get(kmer)
        if c is not None:
            return c
        p = self.params
        rc = pyref.num2str(pyref.revcomp(pyref.str2num(kmer), p.k), p.k)
        return self.get(rc)

    def query_file(self, path: str) -> int:
        """Sum of stored counts over every k-mer emission of a query FASTA
        (reference query_fasta, counter.cpp:314-346), each emission's
        count mod 256: the query is enumerated straight to packed keys,
        kept on the device, and joined against each local shard's arena
        expansion (sort-merge; no shadow index). A key lives on its owner
        shard, and where rows spilled also on their source shards: those
        entries are joined on their owner (_owner_regroup), so each
        emission reads its key's count summed over the shards before the
        wrap. Across processes the spilled entries of another process's
        shard stay where they lie."""
        with spans.call("query_file"):
            p = self.params
            self.finalize()
            qk, qlive = self._query_keys(path)
            if qk is None:
                return 0
            regroup = self._owner_regroup() if self.n_spilled else {}
            total = 0
            for d, lskl in self._local_skl():
                total += sklstore.query_join_keys_total(
                    lskl, qk, qlive, p.k, p.m, p.b, regroup=regroup.get(d))
            if self.multihost:
                total = multihost.process_sum(total, self.mesh)
            return total

    def _owner_regroup(self) -> dict:
        """Per local shard, the regroup of its join expansion
        (sklstore.query_join_keys_total): the entries it holds for another
        local shard (spilled rows) taken out, those that other local
        shards hold for it added."""
        p = self.params
        mine = torch.zeros(self.n_shards, dtype=torch.bool,
                           device=self.device)
        mine[self.my_shards] = True

        def owners(ik, icnt):
            return (store.bucket_of(ik, p.k, p.b) % self.n_shards,
                    icnt != 0)

        moved = {d: [] for d in self.my_shards}
        for d, lskl in self._local_skl():
            with spans.span("join.expand"):
                ik, icnt = sklstore.expand_for_join(lskl, p.k, p.m, p.b)
                owner, live = owners(ik, icnt)
                for t in self.my_shards:
                    sel = live & (owner == t)
                    if t == d or not bool(sel.any()):
                        continue
                    moved[t].append((ik[:, sel], icnt[sel]))
            del ik, icnt

        def regroup(ik, icnt, d):
            owner, live = owners(ik, icnt)
            keep = live & ((owner == d) | ~mine[owner])
            parts = [(ik[:, keep], icnt[keep])] + moved[d]
            return (torch.cat([x for x, _ in parts], dim=1),
                    torch.cat([c for _, c in parts]))

        if not any(moved.values()):
            return {}
        return {d: functools.partial(regroup, d=d) for d in self.my_shards}

    def _query_keys(self, path: str) -> tuple:
        """The query FASTA enumerated straight to packed keys on the
        device: (keys (W, Sq) int32, live (Sq,) bool), or (None, None)
        for a query without k-mers."""
        p = self.params
        dev = self.device
        with spans.span("query.enumerate"):
            qk_parts, qlive_parts = [], []
            carry = enum_ops.zero_carry(self.B, dev)
            for bt in fasta.fasta_batches(path, p.k, self.B, self.window):
                em, carry = enum_ops.enumerate_batch(
                    torch.from_numpy(bt.codes).to(dev),
                    torch.from_numpy(bt.fresh).to(dev),
                    torch.from_numpy(bt.valid_end).to(dev), carry,
                    p.k, p.m, p.b)
                rows = store.make_keys(em.bucket.reshape(-1),
                                       em.key.reshape(4, -1),
                                       em.mini_idx.reshape(-1), p.k, p.b)
                qk_parts.append(_u32.to_i32(rows))
                qlive_parts.append(em.valid.reshape(-1))
            if not qk_parts:
                return None, None
            return torch.cat(qk_parts, dim=1), torch.cat(qlive_parts)

    # -- enumeration / stats -----------------------------------------------

    def items(self) -> Iterator[Tuple[int, int]]:
        """(kmer_value, count mod 256) per stored entry, shard by shard
        (a transient per-shard expansion of the arena). A key split
        between its owner and spill shards appears once per holding
        shard; counts_dict() aggregates. Across processes each process
        yields its own shards only."""
        self.finalize()
        params = self.params
        for d, lskl in self._local_skl():
            view = sklstore.expanded_state(lskl, params.k, params.m,
                                           params.b)
            kmers, counts, _ = readout.entries(view, params)
            for kv, c in zip(kmers, counts):
                yield int(kv), int(c) % 256

    def counts_dict(self) -> dict:
        agg = {}
        for kv, c in self.items():
            agg[kv] = (agg.get(kv, 0) + c) % 256
        return agg

    def stats(self) -> dict:
        self.finalize()
        shard_entries = {}
        n_live_local = 0
        arena_bytes_local = 0
        p = self.params
        for d, lskl in self._local_skl():
            s = sklstore.stats(lskl, p.k, p.m, p.b)
            shard_entries[d] = s["nb_superkmer_rows"]
            n_live_local += s["nb_live_kmers"]
            arena_bytes_local += s["resident_bytes"]
        n_live = multihost.process_sum(n_live_local, self.mesh)
        arena_bytes = multihost.process_sum(arena_bytes_local, self.mesh)
        nb_superkmers = self.n_superkmers
        nb_emitted = self.n_emitted
        if self.multihost:
            # windowed parts are global sums (equal everywhere); repair
            # parts are per-process and must be summed
            nb_superkmers = (nb_superkmers - self._repair_superkmers
                             + multihost.process_sum(
                                 self._repair_superkmers, self.mesh))
            nb_emitted = (nb_emitted - self._repair_emitted
                          + multihost.process_sum(self._repair_emitted,
                                                  self.mesh))
        return dict(n_shards=self.n_shards, nb_kmers=n_live,
                    nb_superkmers=nb_superkmers,
                    nb_emitted=nb_emitted,
                    n_spilled=self.n_spilled,
                    n_repaired_windows=self.n_repaired_windows,
                    shard_entries=shard_entries,
                    index_bytes=arena_bytes,
                    bytes_per_kmer=(arena_bytes / n_live) if n_live
                    else 0.0)

    # -- the per-shard super-k-mer arenas ----------------------------------

    def _local_skl(self):
        """(shard id, single-shard SklState of views) per local shard."""
        s = self.skl
        for i, d in enumerate(self.my_shards):
            yield d, sklstore.SklState(
                bucket=s.bucket[i], meta=s.meta[i], nucs=s.nucs[i],
                data=s.data[i], offs=s.offs[i], n_rows=s.n_rows[i],
                n_fin_rows=s.n_fin_rows[i], n_fin_kmers=s.n_fin_kmers[i])

    def _stack_shards(self, done: dict) -> None:
        """Pad the per-shard arenas `done` (shard id -> SklState) to the
        process-max capacities and stack them into the shard-axis state."""
        with spans.span("shard.stack"):
            rcap = multihost.process_max(max(
                (f.bucket.shape[0] for f in done.values()), default=1),
                self.mesh)
            kcap = multihost.process_max(max(
                (f.data.shape[0] for f in done.values()), default=1),
                self.mesh)
            shards = [sklstore.grow(done[d], rcap, kcap)
                      for d in self.my_shards]
            self.skl = sklstore.SklState(*(
                torch.stack([getattr(f, name) for f in shards])
                for name in sklstore.SklState._fields))
            self._skl_rows_ub = multihost.process_max(
                int(self.skl.n_rows.max()), self.mesh)
            self._bucket_cols = {}

    def finalize(self) -> None:
        """Consolidate every shard's arena (duplicate k-mer counts merged,
        rows grouped by bucket): per-shard sklstore.finalize_device, then
        the shard-axis tensors are stacked again."""
        if self.skl is None or not self._skl_dirty:
            return
        with spans.call("finalize"):
            p = self.params
            done = {}
            for d, lskl in self._local_skl():
                f_before = int(lskl.n_fin_rows)
                fin = sklstore.finalize_device(lskl, p.k, p.m, p.b)
                done[d] = fin
                f_after = int(fin.n_fin_rows)
                segs = self._skl_segments.get(d, [])
                if f_after == 0:
                    segs = []
                elif f_before == 0:
                    segs = [(0, f_after)]  # fused fresh finalize: one run
                elif f_after > f_before:
                    segs = segs + [(f_before, f_after)]
                self._skl_segments[d] = segs
            self._stack_shards(done)
            self._skl_dirty = False

    def skl_stats(self) -> Optional[dict]:
        if self.skl is None:
            return None
        p = self.params
        self.finalize()
        agg = dict(nb_superkmer_rows=0, nb_slots=0, nb_live_kmers=0,
                   resident_bytes=0)
        for d, lskl in self._local_skl():
            s = sklstore.stats(lskl, p.k, p.m, p.b)
            for key in agg:
                agg[key] += s[key]
        for key in list(agg):
            agg[key] = multihost.process_sum(agg[key], self.mesh)
        agg["avg_kmers_per_skl"] = (agg["nb_slots"]
                                    / max(agg["nb_superkmer_rows"], 1))
        agg["bytes_per_kmer"] = (agg["resident_bytes"]
                                 / max(agg["nb_live_kmers"], 1))
        return agg

    def write_kff(self, path: str) -> None:
        """KFF export of the whole sharded index: per-shard super-k-mer
        sections in one file (each process writes `{path}.proc{pid}`
        across processes)."""
        from brisk_tpu_torch.io import kff
        self.finalize()
        states = [lskl for _, lskl in self._local_skl()]
        out = f"{path}.proc{self.pid}" if self.multihost else path
        kff.write_index_skl_many(out, states, self.params)

    def reallocate(self) -> None:
        """Grow minimizer/bucket space (m += 2, b += 2, clamped at b=15)
        and re-key every stored entry under the new minimizer
        decomposition (reference Brisk::reallocate, Brisk.hpp:202-224).
        Entries stay SHARD-LOCAL: the new bucket ids change ownership, but
        ownership is a routing heuristic and readers sum across shards."""
        from brisk_tpu_torch.index import rekey
        self.finalize()
        old = self.params
        new_params = Parameters(k=old.k, m=old.m + 2, b=min(old.b + 2, 15))
        done = {}
        for d, lskl in self._local_skl():
            view = sklstore.expanded_state(lskl, old.k, old.m, old.b)
            new_state = rekey.reindex(view, old, new_params)
            done[d] = sklstore.from_entries(new_state, new_params.k,
                                            new_params.m, new_params.b)
        self.params = new_params
        self._skl_nw = sklstore.skl_dims(new_params.k, new_params.m,
                                         new_params.b)[3]
        self._assemble_skl(done)
        self._skl_dirty = False

    def _assemble_skl(self, done: dict) -> None:
        """Stack fully finalized per-shard arenas into the shard-axis state;
        each shard's segment list is rebuilt from its bucket column
        (sklstore.runs_from_bucket: one run after reallocate, one per
        finalize cycle in a reloaded checkpoint)."""
        for d, fin in done.items():
            nfr = int(fin.n_fin_rows)
            self._skl_segments[d] = sklstore.runs_from_bucket(
                sklstore.fetch_rows(fin.bucket, 0, nfr), nfr)
        self._stack_shards(done)

    # -- persistence -------------------------------------------------------

    def _counters_npz(self) -> dict:
        return dict(k=self.params.k, m=self.params.m, b=self.params.b,
                    n_emitted=self.n_emitted, n_superkmers=self.n_superkmers,
                    n_spilled=self.n_spilled)

    @staticmethod
    def _state_np(state: sklstore.SklState) -> dict:
        """Field -> numpy array with brisk_tpu's dtypes: uint32 columns,
        int32 row counters."""
        return {name: (_u32.to_np(x) if x.dtype == torch.int32
                       else x.cpu().numpy().astype(np.int32))
                for name, x in zip(sklstore.SklState._fields, state)}

    def save(self, path: str) -> None:
        """Sharded checkpoint under brisk_tpu's `.npz` keys: per-shard arena
        arrays with the shard axis kept (`skl_*`), loadable by either
        package on any mesh of the same shard count. Across processes
        each process writes ONLY its shards to `{path}.proc{pid}.npz`
        (`shard{d}_skl_*`); load_multihost_checkpoint reassembles them."""
        self.finalize()
        if self.multihost:
            shards = {}
            for d, lskl in self._local_skl():
                for name, arr in self._state_np(lskl).items():
                    shards[f"shard{d}_skl_{name}"] = arr
            np.savez_compressed(
                f"{path}.proc{self.pid}",
                shard_ids=np.asarray(self.my_shards),
                n_shards=self.n_shards, n_proc=self.n_proc,
                **self._counters_npz(), **shards)
            return
        extra = {f"skl_{name}": arr
                 for name, arr in self._state_np(self.skl).items()}
        np.savez_compressed(path, **self._counters_npz(), **extra)

    @staticmethod
    def _state_from_np(arrays: dict, device) -> sklstore.SklState:
        return sklstore.SklState(**{
            name: (_u32.from_np(a, device) if a.dtype == np.uint32
                   else torch.from_numpy(a.astype(np.int64)).to(device))
            for name, a in arrays.items()})

    @staticmethod
    def _local_mesh(n_shards: int, mesh, kw: dict):
        if mesh is None:
            from brisk_tpu_torch.api import _device
            mesh = sharded.make_mesh(n_shards,
                                     _device(kw.get("device", "cuda")))
        return mesh

    @classmethod
    def load_multihost_checkpoint(cls, path: str, mesh=None, **kw
                                  ) -> "ShardedBrisk":
        """Reassemble a multi-process checkpoint (`{path}.proc*.npz`) in
        one process."""
        files = sorted(glob.glob(f"{path}.proc*.npz"))
        assert files, f"no {path}.proc*.npz checkpoints found"
        parts = [np.load(f) for f in files]
        n_shards = int(parts[0]["n_shards"])
        params = Parameters(k=int(parts[0]["k"]), m=int(parts[0]["m"]),
                            b=int(parts[0]["b"]))
        if "shard0_skl_bucket" not in parts[0]:
            raise ValueError("not a super-k-mer-arena checkpoint")
        self = cls(params, mesh=cls._local_mesh(n_shards, mesh, kw), **kw)
        done = {}
        for z in parts:
            for d in (int(x) for x in z["shard_ids"]):
                done[d] = self._state_from_np(
                    {name: z[f"shard{d}_skl_{name}"]
                     for name in sklstore.SklState._fields}, self.device)
        self._assemble_skl(done)
        self._skl_dirty = False
        self.n_emitted = int(parts[0]["n_emitted"])
        self.n_superkmers = int(parts[0]["n_superkmers"])
        self.n_spilled = sum(int(z["n_spilled"]) for z in parts)
        return self

    @classmethod
    def load(cls, path: str, mesh=None, **kw) -> "ShardedBrisk":
        """Load a sharded checkpoint written by either package's save onto
        `device` (the first CUDA card unless given)."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        params = Parameters(k=int(z["k"]), m=int(z["m"]), b=int(z["b"]))
        if "skl_bucket" not in z:
            raise ValueError("not a super-k-mer-arena checkpoint")
        n_shards = z["skl_bucket"].shape[0]
        mesh = cls._local_mesh(n_shards, mesh, kw)
        assert mesh.n_shards == n_shards, \
            f"checkpoint has {n_shards} shards, mesh has {mesh.n_shards}"
        self = cls(params, mesh=mesh, **kw)
        self.skl = self._state_from_np(
            {name: z[f"skl_{name}"] for name in sklstore.SklState._fields},
            self.device)
        self._skl_rows_ub = int(self.skl.n_rows.max())
        self._skl_dirty = False
        # the file keeps no run lists: rebuild each shard's from its
        # bucket column (every finalize cycle appended one sorted run)
        nfr = np.asarray(z["skl_n_fin_rows"])
        bucket = np.asarray(z["skl_bucket"])
        self._skl_segments = {d: sklstore.runs_from_bucket(bucket[d],
                                                           int(nfr[d]))
                              for d in range(n_shards)}
        self.n_emitted = int(z["n_emitted"])
        self.n_superkmers = int(z["n_superkmers"])
        self.n_spilled = int(z["n_spilled"])
        return self
