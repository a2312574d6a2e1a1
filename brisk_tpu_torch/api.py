"""User-facing Brisk API on PyTorch (port of brisk_tpu.api, the k <= 32
counter main path).

    Brisk(params, batch, window, stack, device)
    warmup / insert_file / insert_sequence      windowed flat transport
    finalize                                    fresh-span consolidation
    get / get_many / get_canonical / query_file / items / counts_dict /
    stats / skl_stats                           serving
    Brisk.load(path, device=...)                the JAX package's .npz

The compacted super-k-mer arena (index.sklstore) is the backing store:
inserts append rows, `finalize()` (run lazily before any read)
consolidates duplicate k-mer counts, scalar gets probe one bucket's rows
from a host copy, batch queries run a sort-merge join against a
transient expansion.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
k > 32 streaming insert, consolidate / consolidate_all, reallocate,
save (and the KFF export), payloads and the sharded facade.
"""

import os
import sys
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from brisk_tpu_torch import _u32, kernels
from brisk_tpu_torch.index import pipeline, readout, sklstore, store
from brisk_tpu_torch.io import windows
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.ops import enumerate as enum_ops
from brisk_tpu_torch.params import Parameters

_INFLIGHT_BYTES = 256 << 20  # host bytes pinned by un-retired flushes


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to brisk_tpu_torch yet (ROADMAP: {item})")


class Brisk:
    """Dynamic k-mer -> count index with batched insert/query.

    Records are split into overlapping windows (io.windows) spread over
    all lanes, a stack of `stack` batches is inserted per flush
    (pipeline.insert_flat_sklnative), and the rare windows whose warm-up
    replay failed the re-sync certificate are re-run exactly through the
    streaming carry path (_retire)."""

    def __init__(self, params: Parameters, batch: int = 512,
                 window: int = 512, stack: int = 8, device="cpu"):
        self.params = params
        self.device = torch.device(device)
        self.batch = batch
        wu = windows.default_warmup(params.k, params.m)
        self.window = max(window, -(-(wu + 48) // 16) * 16)
        self.stack = stack
        self.n_emitted = 0
        self.n_superkmers = 0
        self.n_repaired_windows = 0
        self.n_repair_batches = 0
        self.n_degraded_windows = 0
        self.skl_row_cap = max(16, window // 4)
        self.n_skl_overflows = 0
        self.parser = None           # "native" or "python" (last input)
        self._dirty = False
        self._expanded = None
        self._skl_segments = []
        self._host_cache = None
        self._pending = []
        self._count_acc = []
        self._n_repair_appends = 0
        self._rows_ub = 0
        self._n_fin_host = 0
        self._prefetch = None
        self.segment_rows = 1 << 24
        self.max_segments = 8
        self.consolidate_max_rows = 1 << 25
        _, _, _, nw = sklstore.skl_dims(params.k, params.m, params.b)
        flush_rows = stack * batch * self.skl_row_cap
        rcap = 1 << max(14, (2 * flush_rows - 1).bit_length())
        self.skl = sklstore.empty(rcap, 1 << 14, nw, self.device)

    # -- insertion ---------------------------------------------------------

    def _records(self, path: str):
        """Record stream (uint8 code arrays, or ACGT strings from the
        Python parser when the native one cannot be built); a
        warmup(path=...) prefetch is consumed here."""
        from brisk_tpu_torch import native
        pf, self._prefetch = self._prefetch, None
        if pf is not None and pf[0] == path:
            pf[1].join()
            if pf[2]:
                self.parser = "native"
                return iter(pf[2][0])
        chunks = native.parse_fasta_codes(path)
        if chunks is not None:
            self.parser = "native"
            return iter(chunks)
        self.parser = "python"
        return pyref.read_fasta_chunks(path)

    def _presize_for(self, n_bases_estimate: int) -> None:
        """Grow the arena once up front to what the input will need: at
        most one row per 5 k-mers plus a few flushes of slack."""
        flush_rows = self.stack * self.batch * self.skl_row_cap
        est = n_bases_estimate // 5 + 5 * flush_rows
        self.skl = sklstore.ensure_room(
            self.skl, max(0, est - int(self.skl.n_rows)))

    def warmup(self, n_bases_estimate: int = 0, path: str = None) -> None:
        """Pay set-up before the first request: presize the arena, build
        the CUDA kernels (on a CUDA device) and the native parser, and
        prefetch-parse `path` in a background thread. Eager PyTorch has
        no programs to compile ahead."""
        from brisk_tpu_torch import native
        if path is not None and not n_bases_estimate:
            try:
                n_bases_estimate = os.path.getsize(path)
            except OSError:
                pass
        if n_bases_estimate:
            self._presize_for(n_bases_estimate)
        if self.device.type == "cuda":
            kernels.build()
        native.load()
        if path is not None:
            box = []

            def parse():
                chunks = native.parse_fasta_codes(path)
                if chunks is not None:
                    box.append(chunks)

            t = threading.Thread(target=parse)
            t.start()
            self._prefetch = (path, t, box)

    def insert_file(self, path: str) -> None:
        try:
            self._presize_for(os.path.getsize(path))
        except OSError:
            pass
        self._insert_windowed(self._records(path))

    def insert_sequence(self, seq: str) -> None:
        """Counts every k-mer of one sequence."""
        self._insert_windowed(iter([seq]))
        self._drain()

    def _insert_windowed(self, records) -> None:
        """FLAT transport: a producer thread runs pack_flat and stages the
        packed chunk on the device; the device builds the overlapping
        window lanes itself."""
        import queue
        if self.params.k > 32:
            _not_ported("k > 32 streaming insert (_insert_streaming)",
                        "k > 32 streaming")
        self._drain()
        p = self.params
        packer = windows.WindowPacker(p.k, p.m, self.batch,
                                      l_out=self.window)
        self._prev_tail = None
        self._chain = pipeline.zero_chain(self.device)
        S, B = self.stack, self.batch
        q = queue.Queue(maxsize=2)
        err = []
        dev = self.device

        def producer():
            try:
                for fl in packer.pack_flat(records, S):
                    q.put((fl, torch.from_numpy(fl.chunk4).to(dev),
                           torch.from_numpy(fl.valid_start.reshape(S, B)
                                            ).to(dev),
                           torch.from_numpy(fl.valid_end.reshape(S, B)
                                            ).to(dev)))
            except BaseException as e:  # surface in the consumer
                err.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            self._dispatch_flush(packer, *item)
        t.join()
        if err:
            raise err[0]

    def _dispatch_flush(self, packer, flush, chunk4_d, vs_d, ve_d) -> None:
        """Launch one staged flush; its bookkeeping (counters, repairs,
        overflow re-runs) is deferred to _retire."""
        p = self.params
        flush_rows = self.stack * self.batch * self.skl_row_cap
        if self._rows_ub + flush_rows > self.skl.bucket.shape[0]:
            self._drain()  # exact n_rows; grow only if truly needed
            self.skl = sklstore.ensure_room(self.skl, flush_rows)
        (self.skl, n_sk, n_km, flags, ends,
         _, self._chain) = pipeline.insert_flat_sklnative(
            self.skl, chunk4_d, vs_d, ve_d, self._chain,
            p.k, p.m, p.b, self.skl_row_cap, packer.l_buf, packer.useful)
        self._rows_ub += flush_rows
        self._dirty = True
        self._expanded = None
        self._pending.append(dict(flush=flush, flags=flags, ends=ends,
                                  n_sk=n_sk, n_km=n_km, packer=packer))
        depth = max(4, _INFLIGHT_BYTES // max(flush.chunk4.nbytes, 1))
        if len(self._pending) > depth:
            self._retire(self._pending.pop(0))
        if self._rows_ub - self._n_fin_host > self.segment_rows:
            self.finalize()

    def _drain(self) -> None:
        if self._pending:
            # ONE device->host copy for every pending flush's flags,
            # counter scalars and the final row count
            recs, self._pending = self._pending, []
            sizes = [r["flags"].numel() for r in recs]
            host = torch.cat(
                [r["flags"].reshape(-1).to(torch.int64) for r in recs]
                + [torch.stack([r["n_sk"], r["n_km"]]) for r in recs]
                + [self.skl.n_rows.reshape(1)]).cpu().numpy()
            n_appended0 = self._n_repair_appends
            off = sum(sizes)
            cnts = host[off:off + 2 * len(recs)].reshape(-1, 2)
            pos = 0
            for rec, sz, cnt in zip(recs, sizes, cnts):
                rec["counts_np"] = cnt
                self._retire(rec, host[pos:pos + sz].astype(np.uint8))
                pos += sz
            self._settle_counts()
            if self._n_repair_appends == n_appended0:
                self._rows_ub = int(host[-1])
                return
        self._settle_counts()
        self._rows_ub = int(self.skl.n_rows)

    def _settle_counts(self) -> None:
        """Fold deferred per-flush counter scalars in one copy."""
        if not self._count_acc:
            return
        flat = torch.stack([torch.stack([r[0], r[1]])
                            for r in self._count_acc]).cpu().numpy()
        for (n_sk, n_km), (_, _, n_recs) in zip(flat, self._count_acc):
            self.n_superkmers += int(n_sk) + n_recs
            self.n_emitted += int(n_km)
        self._count_acc = []

    def _retire(self, rec, flags_np=None) -> None:
        """Resolve one flush: fold its counters, repair uncertified lanes
        exactly (batched over runs of consecutive failures, carry-seeded
        from the exact predecessor end state), re-run skl-overflow lanes
        at full width."""
        packer = rec["packer"]
        flush = rec["flush"]
        S, B = self.stack, self.batch
        if "counts_np" in rec:
            n_sk, n_km = rec["counts_np"]
            self.n_superkmers += int(n_sk) + flush.n_records
            self.n_emitted += int(n_km)
        else:
            self._count_acc.append((rec["n_sk"], rec["n_km"],
                                    flush.n_records))

        flags = (rec["flags"].cpu().numpy() if flags_np is None
                 else flags_np).reshape(-1)
        cert_f = (flags & 1).astype(bool)
        rec_f = flush.rec
        win_f = flush.win
        failed = np.nonzero((~cert_f) & (rec_f >= 0))[0]
        repaired_ends = {}
        ends_cache = []

        def ends_f():
            """Per-lane end states, copied to the host lazily."""
            if not ends_cache:
                ends_cache.append([x.cpu().numpy().reshape(S * B)
                                   for x in rec["ends"]])
            return ends_cache[0]

        def end_of(j):
            if j in repaired_ends:
                return repaired_ends[j]
            return tuple(e[j] for e in ends_f())

        MAX_RUN = 64
        runs = []
        for j in (int(x) for x in failed):
            if runs and runs[-1][-1] == j - 1 and len(runs[-1]) < MAX_RUN:
                runs[-1].append(j)
            else:
                runs.append([j])
        checked = []
        for run in runs:
            j0 = run[0]
            r, w = int(rec_f[j0]), int(win_f[j0])
            if w == 0:
                self._degrade(f"window-0 lane flagged uncertified "
                              f"(record {r}); certified by construction")
                repaired_ends[j0] = tuple(e[j0] for e in ends_f())
                if run[1:]:
                    checked.append(run[1:])
                continue
            if j0 == 0:
                seed_ok = (self._prev_tail is not None
                           and self._prev_tail[:2] == (r, w - 1))
            else:
                seed_ok = (rec_f[j0 - 1] == r and win_f[j0 - 1] == w - 1)
            if not seed_ok:
                self._degrade(f"no exact repair seed for record {r} "
                              f"window {w}; window-local replay")
                repaired_ends[j0] = self._repair_window_unchained(flush, j0)
                self.n_repaired_windows += 1
                if run[1:]:
                    checked.append(run[1:])
                continue
            checked.append(run)
        runs = checked
        while runs:
            # a chunk of a split run waits for its predecessor chunk
            in_runs = {j for rr in runs for j in rr}
            ready = [r for r in runs if r[0] - 1 not in in_runs]
            rest = [r for r in runs if r not in ready]
            assert ready
            carries = [self._prev_tail[2]() if r[0] == 0
                       else end_of(r[0] - 1) for r in ready]
            end7s = self._repair_runs(packer, flush, ready, carries)
            for r, e7 in zip(ready, end7s):
                repaired_ends[r[-1]] = e7
            self.n_repaired_windows += sum(len(r) for r in ready)
            self.n_repair_batches += 1
            runs = rest

        live = np.nonzero(rec_f >= 0)[0]
        if len(live):
            j = int(live[-1])
            self._prev_tail = (int(rec_f[j]), int(win_f[j]),
                               lambda jj=j: end_of(jj))

        ovf_f = (flags >> 1).astype(bool)
        for j in np.nonzero(ovf_f & cert_f & (rec_f >= 0))[0]:
            self._repair_skl_overflow(flush, int(j))
            self.n_skl_overflows += 1

    def _append_skl_from_emissions(self, em, valid, first_valid,
                                   row_cap: int) -> None:
        """Build + append compacted rows for a (small) repair emission
        batch at full row width; dead rows are filtered on the host so
        the dense arena stays tombstone-free."""
        p = self.params
        rb, rm, rn, ovf = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, valid,
            first_valid, em.boundary, p.k, p.m, p.b, row_cap)
        assert not bool(ovf.any())
        rb_f = rb.reshape(-1).cpu().numpy()
        live = rb_f != _u32.INVALID
        n_live = int(np.count_nonzero(live))
        if not n_live:
            return
        rm_f = rm.reshape(-1).cpu().numpy()[live]
        rn_f = rn.reshape(rn.shape[0], -1).cpu().numpy()[:, live]
        self.skl = sklstore.ensure_room(self.skl, n_live)
        self.skl = sklstore.append(
            self.skl, _u32.from_np(rb_f[live], self.device),
            _u32.from_np(rm_f, self.device), _u32.from_np(rn_f, self.device))
        self._rows_ub += n_live
        self._n_repair_appends += 1
        self._dirty = True
        self._expanded = None

    def _degrade(self, msg: str) -> None:
        """Log a should-not-happen repair-bookkeeping condition and take
        the exact-where-possible fallback instead of failing the ingest."""
        self.n_degraded_windows += 1
        print(f"[brisk_tpu_torch] degraded repair: {msg}", file=sys.stderr)

    def _lane_tensors(self, flush, j: int):
        codes1 = torch.from_numpy(flush.codes[j][None, :].copy()).to(
            self.device)
        vs1 = torch.tensor([int(flush.valid_start[j])], device=self.device)
        ve1 = torch.tensor([int(flush.valid_end[j])], device=self.device)
        return codes1, vs1, ve1

    def _repair_window_unchained(self, flush, j):
        """Window-local fresh replay of one failed lane whose exact
        predecessor state is unavailable; returns its end-state 7-tuple."""
        p = self.params
        codes1, vs1, ve1 = self._lane_tensors(flush, int(j))
        one = torch.ones(1, dtype=torch.bool, device=self.device)
        em, _ = enum_ops.enumerate_batch(
            codes1, one, ve1, enum_ops.zero_carry(1, self.device),
            p.k, p.m, p.b, valid_start=vs1)
        valid = em.valid
        self.n_emitted += int(valid.sum())
        self.n_superkmers += int((em.boundary & valid).sum())
        margin = p.k - 1
        L_out = valid.shape[1]
        pos = torch.arange(margin, margin + L_out, device=self.device)
        first_valid = pos[None, :] == vs1[:, None]
        self._append_skl_from_emissions(em, valid, first_valid, L_out)
        return self._end_states(em, np.asarray([int(ve1[0])]), [0])[0]

    def _end_states(self, em, ve, lanes):
        """Exact per-lane machine-state 7-tuples at each lane's OWN ve;
        heavy is re-derived from the minimizer's decycling class."""
        p = self.params
        km = p.k - p.m
        margin = p.k - 1
        dede = pyref.get_decycling(p.m)
        f_lo, f_hi, f_rc, f_mi, f_hh, f_hl = (
            x.cpu().numpy() for x in (em.mini_lo, em.mini_hi, em.use_rc,
                                      em.mini_idx, em.hash_hi, em.hash_lo))
        out = []
        for i in lanes:
            idx = int(ve[i]) - margin - 1
            rev = bool(f_rc[i, idx])
            mi = int(f_mi[i, idx])
            mini = (int(f_hi[i, idx]) << 32) | int(f_lo[i, idx])
            out.append((int(f_lo[i, idx]), int(f_hi[i, idx]),
                        (km - mi) if rev else mi, rev,
                        dede.mem_double(mini), int(f_hh[i, idx]),
                        int(f_hl[i, idx])))
        return out

    def _repair_skl_overflow(self, flush, j) -> None:
        """Re-run one certified lane's skl segmentation at full width."""
        p = self.params
        codes1, vs1, ve1 = self._lane_tensors(flush, int(j))
        one = torch.ones(1, dtype=torch.bool, device=self.device)
        em, _ = enum_ops.enumerate_batch(
            codes1, one, ve1, enum_ops.zero_carry(1, self.device),
            p.k, p.m, p.b, valid_start=vs1)
        L_out = em.valid.shape[1]
        margin = p.k - 1
        pos = torch.arange(margin, margin + L_out, device=self.device)
        first_valid = pos[None, :] == vs1[:, None]
        self._append_skl_from_emissions(em, em.valid, first_valid, L_out)

    def _repair_runs(self, packer, flush, runs, carries):
        """Exact re-run of runs of consecutive failed windows through the
        streaming carry path: each run is one contiguous genome span, so
        one lane; independent runs ride parallel lanes of one call.
        Returns the exact end 7-tuple of each run's LAST window."""
        p = self.params
        warmup, useful, l_buf = packer.warmup, packer.useful, packer.l_buf
        R = len(runs)
        Rp = 1 << max(2, (R - 1).bit_length())
        span_max = 1 << (max(len(r) for r in runs) - 1).bit_length()
        L_rep = (l_buf - warmup) + (span_max - 1) * useful
        codes = np.zeros((Rp, L_rep), dtype=np.uint8)
        ve = np.zeros(Rp, dtype=np.int64)
        carry_np = [np.zeros(Rp, dtype=bool if f == 3 else np.int64)
                    for f in range(7)]
        win_codes = flush.codes
        for i, (run, c7) in enumerate(zip(runs, carries)):
            pos = l_buf - warmup
            codes[i, :pos] = win_codes[run[0]][warmup:]
            for j in run[1:]:
                codes[i, pos:pos + useful] = win_codes[j][l_buf - useful:]
                pos += useful
            ve[i] = (len(run) - 1) * useful + \
                int(flush.valid_end[run[-1]]) - warmup
            for f in range(7):
                carry_np[f][i] = c7[f]
        dev = self.device
        carry = enum_ops.MinimizerState(
            *(torch.from_numpy(x).to(dev) for x in carry_np))
        em, _ = enum_ops.enumerate_batch(
            torch.from_numpy(codes).to(dev),
            torch.zeros(Rp, dtype=torch.bool, device=dev),
            torch.from_numpy(ve).to(dev), carry, p.k, p.m, p.b)
        valid = em.valid
        self.n_emitted += int(valid.sum())
        self.n_superkmers += int((em.boundary & valid).sum())
        first_valid = torch.zeros_like(valid)
        first_valid[:, 0] = True
        self._append_skl_from_emissions(em, valid, first_valid,
                                        valid.shape[1])
        return self._end_states(em, ve, list(range(R)))

    # -- finalization ------------------------------------------------------

    def finalize(self) -> None:
        """Consolidate the fresh rows of the arena into a new
        bucket-grouped segment (sklstore.finalize_device)."""
        p = self.params
        self._drain()
        f_before = int(self.skl.n_fin_rows)
        self.skl = sklstore.finalize_device(self.skl, p.k, p.m, p.b)
        self._rows_ub = int(self.skl.n_rows)
        f_after = int(self.skl.n_fin_rows)
        if f_after == 0:
            self._skl_segments = []
        elif f_after > f_before:
            self._skl_segments.append((f_before, f_after))
        self._n_fin_host = f_after
        self._host_cache = None
        self._dirty = False
        if (len(self._skl_segments) > self.max_segments
                and f_after <= self.consolidate_max_rows):
            self.consolidate()

    def consolidate(self) -> None:
        _not_ported("consolidate (merge finalize segments)",
                     "consolidate / maintenance")

    def _ensure_final(self) -> None:
        self._drain()
        if self._dirty:
            self.finalize()

    def _expanded_view(self) -> store.IndexState:
        self._ensure_final()
        if self._expanded is None:
            p = self.params
            self._expanded = sklstore.expanded_state(self.skl, p.k, p.m,
                                                     p.b)
        return self._expanded

    # -- lookup ------------------------------------------------------------

    def get_canonical(self, kmer: str) -> Optional[int]:
        """Strand-insensitive count: tries both orientations."""
        c = self.get(kmer)
        if c is not None:
            return c
        p = self.params
        rc = pyref.num2str(pyref.revcomp(pyref.str2num(kmer), p.k), p.k)
        return self.get(rc)

    def get(self, kmer: str) -> Optional[int]:
        """Count of one k-mer (orientation-sensitive like the reference),
        or None if absent."""
        return self.get_many([kmer])[0]

    def get_many(self, kmers) -> list:
        """Batched point lookups: one vectorized numpy keying pass, then
        one probe of a host copy of the arena per distinct bucket.
        Returns counts (mod 256) or None per query k-mer."""
        from brisk_tpu_torch.index import keying
        p = self.params
        kmers = list(kmers)
        if not kmers:
            return []
        for s in kmers:
            if len(s) != p.k:
                raise ValueError(f"need a {p.k}-mer, got {len(s)} bases")
        buckets, cols = keying.key_batch(keying.strs_to_codes(kmers),
                                         p.m, p.b)
        self._ensure_final()
        if self._host_cache is None:
            self._host_cache = sklstore.host_cache(self.skl)
        out = [None] * len(kmers)
        for bk in np.unique(buckets):
            sel = np.nonzero(buckets == bk)[0]
            found, vals = sklstore.probe_np(self._host_cache,
                                            cols[:, sel], int(bk),
                                            p.k, p.m, p.b,
                                            segments=self._skl_segments)
            for j, i in enumerate(sel):
                if bool(found[j]):
                    out[int(i)] = int(vals[j]) % 256
        return out

    def query_file(self, path: str) -> int:
        """Sum of stored counts over every k-mer emission of a query
        FASTA (reference query_fasta, counter.cpp:314-346): the query is
        enumerated into a temporary arena through the insert pipeline and
        resolved with one sort-merge join against the finalized index."""
        p = self.params
        self._ensure_final()
        qbr = Brisk(p, batch=self.batch, window=self.window,
                    stack=self.stack, device=self.device)
        qbr.insert_file(path)
        # retire the shadow's flushes so its repaired windows and
        # overflow lanes join too (brisk_tpu's query_file skips this and
        # undercounts inputs that need repairs)
        qbr._drain()
        box = [qbr.skl]  # ownership moves to the join
        qbr.skl = None
        del qbr
        return sklstore.query_join_total(self.skl, box, p.k, p.m, p.b)

    # -- enumeration -------------------------------------------------------

    def items(self) -> Iterator[Tuple[int, int]]:
        """(kmer_value, count mod 256) per stored entry."""
        kmers, counts, _ = readout.entries(self._expanded_view(),
                                           self.params)
        for kv, c in zip(kmers, counts):
            yield int(kv), int(c) % 256

    def counts_dict(self) -> dict:
        agg = {}
        for kv, c in self.items():
            agg[kv] = (agg.get(kv, 0) + c) % 256
        return agg

    # -- maintenance -------------------------------------------------------

    def stats(self) -> dict:
        p = self.params
        self._ensure_final()
        n_rows = int(self.skl.n_rows)
        n_live = sklstore.distinct_count(self.skl, p.k, p.m, p.b)
        buckets = sklstore.fetch_rows(self.skl.bucket, 0, n_rows)
        sizes = sklstore.fetch_rows(self.skl.meta, 0, n_rows) & 0xFF
        if n_rows:
            nb_buckets = int(len(np.unique(buckets)))
            largest = int(np.bincount(buckets, weights=sizes).max())
        else:
            nb_buckets = largest = 0
        nw = self.skl.nucs.shape[0]
        s_max = sklstore.skl_dims(p.k, p.m, p.b)[1]
        resident = n_rows * (8 + 4 * nw) + n_rows * s_max
        return dict(nb_buckets=nb_buckets, nb_kmers=n_live,
                    nb_superkmers=self.n_superkmers,
                    nb_emitted=self.n_emitted,
                    nb_superkmer_rows=n_rows,
                    largest_bucket_entries=largest,
                    index_bytes=resident,
                    bytes_per_kmer=(resident / n_live) if n_live else 0.0)

    def skl_stats(self) -> dict:
        self._ensure_final()
        p = self.params
        return sklstore.stats(self.skl, p.k, p.m, p.b)

    def reallocate(self) -> None:
        _not_ported("reallocate (m += 2, b += 2 re-key)", "reallocate")

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        _not_ported("save (and the KFF export)", "counter app / save / KFF")

    @classmethod
    def load(cls, path: str, batch: int = 512, window: int = 512,
             device="cpu") -> "Brisk":
        """Load a super-k-mer-arena checkpoint written by the JAX
        package's Brisk.save onto `device`."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        params = Parameters(k=int(z["k"]), m=int(z["m"]), b=int(z["b"]))
        if "skl_bucket" not in z:
            raise ValueError("not a super-k-mer-arena checkpoint")
        self = cls(params, batch=batch, window=window, device=device)
        _, _, _, nw_now = sklstore.skl_dims(params.k, params.m, params.b)
        if z["skl_nucs"].shape[0] != nw_now:
            raise ValueError("checkpoint row format mismatch (different "
                             "SKL_SIZE_CAP build)")
        nr, nfr, nfk = (int(x) for x in z["skl_n"])
        self.skl = sklstore.from_numpy(dict(
            bucket=z["skl_bucket"], meta=z["skl_meta"],
            nucs=z["skl_nucs"], data=z["skl_data"], offs=z["skl_offs"],
            n_rows=nr, n_fin_rows=nfr, n_fin_kmers=nfk), self.device)
        self._rows_ub = nr
        self._n_fin_host = nfr
        if "skl_segments" in z:
            self._skl_segments = [tuple(int(x) for x in row)
                                  for row in z["skl_segments"]]
        elif nfr:
            self._skl_segments = [(0, nfr)]
        self.n_emitted = int(z["n_emitted"])
        self.n_superkmers = int(z["n_superkmers"])
        return self
