"""BriskData — the generic-payload index (`Brisk<DATA>`, reference
Brisk.hpp:23-42) on PyTorch (port of brisk_tpu.data_api).

Each k-mer carries `width` u32 payload lanes merged under static
per-lane kinds (index.payload). The canonical width-2 instantiation is
count + last position: kinds ("sum", "max") with ascending positions.
The reference's get() -> mutate DATA* cycle under locks becomes a
batched upsert: update() appends (key, payload) columns and the next
compaction merges them under the lane kinds.

Compaction runs at the same points as in brisk_tpu (before a flush,
repair batch or update that would overflow the log, and lazily before
any read), so the state equals brisk_tpu's array for array after every
step.
"""

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from brisk_tpu_torch import spans
from brisk_tpu_torch._u32 import M32, from_np, to_np
from brisk_tpu_torch.api import _device, end_states
from brisk_tpu_torch.index import (flush_graph, payload, pipeline,
                                   readout, store)
from brisk_tpu_torch.io import fasta, windows
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.ops import enumerate as enum_ops
from brisk_tpu_torch.params import Parameters

U32 = np.uint32


class BriskData:
    """Dynamic k-mer -> (D u32 lanes) index with batched
    insert/get/update and merge-on-compact semantics, on `device` (the
    first CUDA card unless given; it raises without one).

    insert_file runs the windowed sequence-parallel pipeline of the
    counter (pipeline.insert_windows_payload) with the window-continuity
    chain and batched exact repairs; file-path lanes are (count, record
    position). On a CUDA device each flush is one CUDA graph replay of
    that program (flush_graph.insert_payload; the graph captured at the
    geometry's first flush, shared by every BriskData of it); the rare
    repairs run eagerly. insert_sequence also accepts arbitrary
    per-position extras."""

    def __init__(self, params: Parameters, width: int = 2,
                 kinds: Tuple[str, ...] = None, batch: int = 512,
                 window: int = 256, capacity: int = 1 << 14,
                 stack: int = 4, device="cuda"):
        if kinds is None:
            kinds = ("sum",) + ("max",) * (width - 1)
        if len(kinds) != width:
            raise ValueError(f"{len(kinds)} kinds for width {width}")
        if kinds[0] != "sum":
            raise ValueError("lane 0 is the count lane (kind 'sum')")
        self.params = params
        self.device = _device(device)
        self.width = width
        self.kinds = tuple(kinds)
        self.batch = batch
        wu = windows.default_warmup(params.k, params.m)
        self.window = max(window, -(-(wu + 48) // 16) * 16)
        self.stack = stack
        self.W = store.key_words(params.k, params.b)
        self.state = payload.empty(capacity, self.W, width, self.device)
        self.n_emitted = 0
        self.n_repaired_windows = 0
        self._dirty = False

    # -- insertion -----------------------------------------------------------

    def insert_file(self, path: str) -> None:
        """Windowed batched insertion of a FASTA; payload = (count,
        position-within-record) under the instance's lane kinds."""
        from brisk_tpu_torch import native
        with spans.call("insert_file"):
            with spans.span("parse"):
                chunks = native.parse_fasta_codes(path)
                records = iter(chunks) if chunks is not None else \
                    pyref.read_fasta_chunks(path)
            self._insert_windowed(records)

    def insert_sequence(self, seq: str, extra: np.ndarray = None) -> None:
        """Insert every k-mer of `seq`. Lane 0 gets +1 (count); lanes 1..
        take `extra` ((width-1, n_kmers) u32, indexed by k-mer start
        position). Default: the start position on every lane (with the
        default ("sum", "max") kinds, count + LAST occurrence)."""
        p = self.params
        n_k = len(seq) - p.k + 1
        if n_k <= 0:
            return
        if extra is None:
            self._insert_windowed(iter([seq]))
            return
        if extra.shape != (self.width - 1, n_k):
            raise ValueError(f"extra must be {(self.width - 1, n_k)}, got "
                             f"{extra.shape}")
        dev = self.device
        packer = fasta.BatchPacker(p.k, 1, self.window)
        carry = enum_ops.zero_carry(1, dev)
        offset = 0
        for bt in packer.pack(iter([seq])):
            em, carry = enum_ops.enumerate_batch(
                torch.from_numpy(bt.codes).to(dev),
                torch.from_numpy(bt.fresh).to(dev),
                torch.from_numpy(bt.valid_end).to(dev), carry,
                p.k, p.m, p.b)
            rows = store.make_keys(em.bucket.reshape(-1),
                                   em.key.reshape(4, -1),
                                   em.mini_idx.reshape(-1), p.k, p.b)
            L_out = em.valid.shape[1]
            vals = np.zeros((self.width, L_out), dtype=U32)
            take = min(L_out, n_k - offset)
            vals[0, :take] = 1
            vals[1:, :take] = extra[:, offset:offset + take]
            offset += take
            self.state = payload.ensure_room(self.state, L_out)
            self.state = payload.append(self.state, rows,
                                        from_np(vals, dev),
                                        em.valid.reshape(-1))
            self.n_emitted += bt.n_kmers
        self._dirty = True

    def _insert_windowed(self, records) -> None:
        p = self.params
        packer = windows.WindowPacker(p.k, p.m, self.batch,
                                      l_out=self.window)
        self._prev_tail = None
        self._chain = pipeline.zero_chain(self.device)
        S, B = self.stack, self.batch
        pending = []
        for bt in spans.iterate("pack", packer.pack(records)):
            pending.append(bt)
            if len(pending) == S:
                self._flush(packer, pending)
                pending = []
        if pending:
            # empty lanes (rec -1) pad the last stack; they neither count
            # nor repair
            while len(pending) < S:
                pending.append(windows.WinBatch(
                    np.zeros((B, packer.l_buf4), np.uint8),
                    np.zeros(B, np.int32), np.zeros(B, np.int32), 0, 0,
                    np.full(B, -1, np.int64), np.zeros(B, np.int32),
                    packer.l_buf))
            self._flush(packer, pending)
        self._dirty = True

    def _room_for(self, raw: int) -> None:
        """Compact first if `raw` more columns would overflow the log,
        then grow until they fit (brisk_tpu's trigger points)."""
        if self.state.n_used + raw > self.state.keys.shape[1]:
            self.compact()
        self.state = payload.ensure_room(self.state, raw)

    def _stage(self, packer, batches) -> tuple:
        """A stack's inputs of insert_windows_payload on the device:
        (codes (S, B, L_buf) unpacked, valid_start, valid_end, pos0)."""
        S, B, dev = len(batches), self.batch, self.device
        codes4 = torch.from_numpy(np.stack([bt.codes4 for bt in batches])
                                  ).to(dev)
        codes = pipeline._unpack4_device(codes4.reshape(S * B, -1),
                                         packer.l_buf).reshape(S, B, -1)

        def stacked(arrays):
            return torch.from_numpy(np.stack(arrays)).to(dev)

        return (codes, stacked([bt.valid_start for bt in batches]),
                stacked([bt.valid_end for bt in batches]),
                stacked([bt.win.astype(np.int64) * packer.useful
                         for bt in batches]))

    def _flush(self, packer, batches) -> None:
        p = self.params
        S, B = len(batches), self.batch
        with spans.span("pack"):
            staged = self._stage(packer, batches)
        self._room_for(S * B * packer.l_out)
        with spans.span("flush"):
            (self.state, n_km, cert, ends,
             self._chain) = flush_graph.insert_payload(
                self.state, *staged, self._chain, p.k, p.m, p.b, self.width)
        with spans.span("readback"):
            host = torch.cat([cert.reshape(-1).to(torch.int64),
                              n_km.reshape(1)]).cpu().numpy()
        self.n_emitted += int(host[-1])

        cert_f = host[:-1].astype(bool)
        rec_f = np.concatenate([bt.rec for bt in batches])
        win_f = np.concatenate([bt.win for bt in batches])
        failed = [int(j) for j in np.nonzero(~cert_f & (rec_f >= 0))[0]]
        repaired_ends = {}
        ends_cache = []

        def end_of(j):
            if j in repaired_ends:
                return repaired_ends[j]
            if not ends_cache:  # per-lane end states, copied lazily
                with spans.span("readback"):
                    ends_cache.extend(x.cpu().numpy().reshape(S * B)
                                      for x in ends)
            return tuple(e[j] for e in ends_cache)

        # repair failure runs as contiguous streaming spans (one lane per
        # run, batched across runs; the scheme of api.Brisk)
        MAX_RUN = 64
        runs = []
        for j in failed:
            if runs and runs[-1][-1] == j - 1 and len(runs[-1]) < MAX_RUN:
                runs[-1].append(j)
            else:
                runs.append([j])
        while runs:
            blocked = {j for rr in runs for j in rr}
            ready = [r for r in runs if r[0] - 1 not in blocked]
            rest = [r for r in runs if r[0] - 1 in blocked]
            carries = [self._prev_tail[2] if r[0] == 0 else end_of(r[0] - 1)
                       for r in ready]
            with spans.span("repair"):
                end7s = self._repair_runs(packer, batches, ready, carries)
            for r, e7 in zip(ready, end7s):
                repaired_ends[r[-1]] = e7
            self.n_repaired_windows += sum(len(r) for r in ready)
            runs = rest

        live = np.nonzero(rec_f >= 0)[0]
        if len(live):
            j = int(live[-1])
            self._prev_tail = (int(rec_f[j]), int(win_f[j]), end_of(j))

    def _repair_runs(self, packer, batches, runs, carries):
        """Exact streaming re-run of runs of consecutive failed windows
        with the (count, position) payload; returns the exact end state
        of each run's last window (cf. api.Brisk._repair_runs)."""
        p = self.params
        warmup, useful, l_buf = packer.warmup, packer.useful, packer.l_buf
        B, dev = self.batch, self.device
        R = len(runs)
        Rp = 1 << max(2, (R - 1).bit_length())
        span_max = 1 << (max(len(r) for r in runs) - 1).bit_length()
        L_rep = (l_buf - warmup) + (span_max - 1) * useful
        codes = np.zeros((Rp, L_rep), dtype=np.uint8)
        ve = np.zeros(Rp, dtype=np.int64)
        base = np.zeros(Rp, dtype=np.int64)
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
            # the k-mer index in the record of the lane's first emission
            base[i] = int(batches[s0].win[lane0]) * useful + warmup
            for f in range(7):
                carry_np[f][i] = c7[f]
        carry = enum_ops.MinimizerState(
            *(torch.from_numpy(x).to(dev) for x in carry_np))
        em, _ = enum_ops.enumerate_batch(
            torch.from_numpy(codes).to(dev),
            torch.zeros(Rp, dtype=torch.bool, device=dev),
            torch.from_numpy(ve).to(dev), carry, p.k, p.m, p.b)
        rows = store.make_keys(em.bucket.reshape(-1), em.key.reshape(4, -1),
                               em.mini_idx.reshape(-1), p.k, p.b)
        valid = em.valid.reshape(-1)
        L_out = em.valid.shape[1]
        pos = ((torch.from_numpy(base).to(dev)[:, None]
                + torch.arange(L_out, device=dev)[None, :]) & M32
               ).reshape(-1)
        vals = torch.stack([torch.ones_like(pos)] + [pos] * (self.width - 1))
        self._room_for(rows.shape[1])
        self.state = payload.append(self.state, rows, vals, valid)
        self.n_emitted += int(valid.sum())
        return end_states(em, ve, range(R), p.k, p.m)

    def update(self, kmers, values: np.ndarray) -> None:
        """Batched upsert: merge `values` ((D, n) u32) into the entries of
        the given k-mer strings under the lane kinds (new keys are
        inserted). Compaction is deferred (capacity-triggered or lazy on
        read), so an update stream pays no sort per call."""
        values = np.asarray(values, dtype=U32)
        if values.shape != (self.width, len(kmers)):
            raise ValueError(f"values must be {(self.width, len(kmers))}, "
                             f"got {values.shape}")
        cols = np.stack([self._pack(km) for km in kmers], axis=1)
        self._room_for(len(kmers))
        self.state = payload.append(
            self.state, from_np(cols, self.device),
            from_np(values, self.device),
            torch.ones(len(kmers), dtype=torch.bool, device=self.device))
        self._dirty = True

    def compact(self) -> None:
        with spans.span("compact"):
            self.state = payload.compact(self.state, self.kinds)
        self._dirty = False

    def _ensure_compact(self) -> None:
        if self._dirty or self.state.n_used > self.state.n_sorted:
            self.compact()

    # -- lookup --------------------------------------------------------------

    def _pack(self, kmer: str) -> np.ndarray:
        p = self.params
        if len(kmer) != p.k:
            raise ValueError(f"need a {p.k}-mer, got {len(kmer)} bases")
        dede = pyref.get_decycling(p.m)
        km = pyref.str2kmer_record(kmer, p.m, dede)
        key = pyref.hash_kmer_minimizer(km.kmer, km.minimizer_idx, p.m,
                                        dede)
        slice_hash = pyref.bfc_hash_64(
            (km.kmer >> (2 * km.minimizer_idx)) & p.m_mask, p.m_mask, dede)
        bucket = pyref.bucket_id(slice_hash, p)
        return store.pack_key_np(bucket, key, km.minimizer_idx, p.k, p.b)

    def get(self, kmer: str) -> Optional[Tuple[int, ...]]:
        """All D payload lanes of one k-mer, or None (orientation-
        sensitive keying, like Brisk::get, Brisk.hpp:63-69)."""
        self._ensure_compact()
        cols = from_np(self._pack(kmer)[:, None], self.device)
        found, vals = payload.lookup(self.state, cols)
        if bool(found[0]):
            return tuple(int(v) for v in to_np(vals[:, 0]))
        return None

    def _entries(self):
        """(kmer hi u64, kmer lo u64, lanes (D, n) u32) of the compacted
        state, in stored order."""
        self._ensure_compact()
        n = self.state.n_sorted
        tmp = store.IndexState(self.state.keys[:, :n],
                               torch.ones(n, dtype=torch.int64), n, n)
        _, hi, lo, _, _ = readout.entries_u64(tmp, self.params)
        return hi, lo, to_np(self.state.data[:, :n])

    def items(self) -> Iterator[Tuple[int, Tuple[int, ...]]]:
        """(kmer_value, (lane0, .., laneD-1)) per stored entry."""
        hi, lo, data = self._entries()
        for i in range(hi.shape[0]):
            kv = (int(hi[i]) << 64) | int(lo[i])
            yield kv, tuple(int(x) for x in data[:, i])

    # -- maintenance ---------------------------------------------------------

    def reallocate(self) -> None:
        """m += 2, b += 2 (b clamped at 15) re-keying with the payload
        lanes carried; entries that collapse to one key merge under the
        lane kinds (the reference keeps an arbitrary one, Brisk.hpp:219;
        see index.rekey)."""
        from brisk_tpu_torch.index import rekey
        p = self.params
        new = Parameters(k=p.k, m=p.m + 2, b=min(p.b + 2, 15))
        hi, lo, vals = self._entries()
        n = hi.shape[0]
        dev = self.device
        out = payload.empty(max(1 << 10, int(2 ** np.ceil(
            np.log2(max(n, 1) * 2)))), store.key_words(new.k, new.b),
            self.width, dev)
        batch = 1 << 16
        for s in range(0, n, batch):
            e = min(s + batch, n)
            codes = rekey._codes_from_values(hi[s:e], lo[s:e], new.k)
            rows = rekey._rekey_batch(
                torch.from_numpy(codes.astype(np.int64)).to(dev),
                new.k, new.m, new.b)
            out = payload.ensure_room(out, rows.shape[1])
            out = payload.append(out, rows, from_np(vals[:, s:e], dev),
                                 torch.ones(rows.shape[1], dtype=torch.bool,
                                            device=dev))
        self.state = payload.compact(out, self.kinds)
        self.params = new

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """.npz checkpoint under brisk_tpu's keys (uint32 `keys` and
        `data`), so each package loads the other's file."""
        self._ensure_compact()
        arrays = payload.to_numpy(self.state)
        np.savez_compressed(
            path, keys=arrays["keys"], data=arrays["data"],
            n_sorted=arrays["n_sorted"], n_used=arrays["n_used"],
            k=self.params.k, m=self.params.m, b=self.params.b,
            kinds=np.array(self.kinds), n_emitted=self.n_emitted)

    @classmethod
    def load(cls, path: str, device="cuda", **kw) -> "BriskData":
        """Load a checkpoint written by either package's BriskData.save
        onto `device` (the first CUDA card unless given)."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        params = Parameters(k=int(z["k"]), m=int(z["m"]), b=int(z["b"]))
        kinds = tuple(str(x) for x in z["kinds"])
        self = cls(params, width=len(kinds), kinds=kinds, capacity=1,
                   device=device, **kw)
        self.state = payload.from_numpy(z["keys"], z["data"],
                                        z["n_sorted"], z["n_used"],
                                        self.device)
        self.n_emitted = int(z["n_emitted"])
        return self
