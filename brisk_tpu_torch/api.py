"""User-facing Brisk API on PyTorch (port of brisk_tpu.api, the
single-device index).

    Brisk(params, batch, window, stack, device)  device: the first CUDA
                                                card unless given ("cpu")
    warmup / insert_file / insert_sequence      k <= 32: windowed flat
                                                transport; k > 32: one
                                                record per lane, streamed
    finalize / consolidate                      span consolidation and
                                                whole-arena maintenance
    get / get_many / get_canonical / query_file / items / counts_dict /
    stats / skl_stats                           serving
    reallocate                                  m += 2, b += 2 re-key
    save / Brisk.load(path, device=...)         .npz checkpoints, the
                                                same keys as brisk_tpu's

The compacted super-k-mer arena (index.sklstore) is the backing store:
inserts append rows, `finalize()` (run lazily before any read)
consolidates duplicate k-mer counts, scalar gets probe one bucket's rows
from a host copy, batch queries run a sort-merge join against a
transient expansion. KFF export is io.kff.

The generic-payload index (`Brisk<DATA>`) is data_api.BriskData; the
sharded index is parallel.facade.ShardedBrisk.
"""

import os
import sys
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from brisk_tpu_torch import _u32, kernels, spans
from brisk_tpu_torch.index import (flush_graph, pipeline, readout,
                                   sklstore, store)
from brisk_tpu_torch.io import fasta, windows
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.ops import enumerate as enum_ops
from brisk_tpu_torch.params import Parameters

_INFLIGHT_BYTES = 256 << 20  # host bytes pinned by un-retired flushes


def _device(device) -> torch.device:
    """The index's torch device. A CUDA device needs a card: without one
    this raises instead of running on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Brisk(device={str(device)!r}): no CUDA card is "
                           "available (pass device='cpu' to index on the "
                           "host)")
    return dev


def end_states(em, ve, lanes, k: int, m: int) -> list:
    """Exact per-lane machine-state 7-tuples (MinimizerState order) at
    each lane's OWN valid_end `ve[i]`, from a carry-path enumeration; heavy
    is re-derived from the minimizer's decycling class."""
    km = k - m
    margin = k - 1
    dede = pyref.get_decycling(m)
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


class Brisk:
    """Dynamic k-mer -> count index with batched insert/query.

    For k <= 32, records are split into overlapping windows (io.windows)
    spread over all lanes, a stack of `stack` batches is inserted per
    flush (pipeline.insert_flat_sklnative), and the rare windows whose
    warm-up replay failed the re-sync certificate are re-run exactly
    through the streaming carry path (_retire). For k > 32 one record
    rides one lane with the exact carry (pipeline.insert_stream_sklnative)
    and nothing repairs. On a CUDA device each flush of either program is
    one CUDA graph replay (index.flush_graph), the graph shared by every
    Brisk of the same geometry."""

    def __init__(self, params: Parameters, batch: int = 512,
                 window: int = 512, stack: int = 8, device="cuda"):
        self.params = params
        self.device = _device(device)
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
        with spans.call("Brisk"):
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
        with spans.span("parse"):
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

    def _stream_geometry(self, rec_len=None) -> fasta.BatchPacker:
        """Lane geometry for the k > 32 streaming path. One record rides
        one lane, so l_new follows the record-length profile (quantized
        to 64) to keep short-read lanes full; long records still stream
        across batches in the same lane."""
        p = self.params
        if rec_len is None:
            l_new = self.window
        else:
            l_new = min(self.window,
                        max(64, -(-(rec_len - (p.k - 1)) // 64) * 64))
        return fasta.BatchPacker(p.k, self.batch, l_new)

    def warmup(self, n_bases_estimate: int = 0,
               record_len_hint: int = None, path: str = None) -> None:
        """Pay set-up before the first request: presize the arena (for
        k > 32 also room for one streaming flush at the lane geometry
        `record_len_hint` predicts), build the CUDA kernels and capture
        the flush's CUDA graph at this geometry (on a CUDA device), load
        the native parser, and prefetch-parse `path` in a background
        thread."""
        from brisk_tpu_torch import native
        if path is not None and not n_bases_estimate:
            try:
                n_bases_estimate = os.path.getsize(path)
            except OSError:
                pass
        if n_bases_estimate:
            self._presize_for(n_bases_estimate)
        if self.params.k > 32:
            l_new = self._stream_geometry(record_len_hint).l_new
            self.skl = sklstore.ensure_room(
                self.skl, self.stack * self.batch * l_new)
        if self.device.type == "cuda":
            kernels.build()
            program, static, inputs = self._zero_flush(record_len_hint)
            flush_graph.runner(program, self.device, static, inputs)
        native.load()
        if path is not None:
            box = []
            ctx = spans.context()

            def parse():
                spans.adopt(ctx)
                with spans.span("parse"):
                    chunks = native.parse_fasta_codes(path)
                if chunks is not None:
                    box.append(chunks)

            t = threading.Thread(target=parse)
            t.start()
            self._prefetch = (path, t, box)

    def _flat_static(self, packer) -> tuple:
        """The k <= 32 flush program's static arguments."""
        p = self.params
        return (p.k, p.m, p.b, self.skl_row_cap, packer.l_buf,
                packer.useful)

    def _zero_flush(self, record_len_hint: int = None) -> tuple:
        """(program, static arguments, zero inputs) of one flush at this
        geometry (for k > 32 at the lane length `record_len_hint`
        predicts), shaped and typed as insert_file's flushes are."""
        p, S, B, dev = self.params, self.stack, self.batch, self.device
        if p.k > 32:
            packer = self._stream_geometry(record_len_hint)
            return "stream", (p.k, p.m, p.b, packer.l_new), (
                torch.zeros((S, B, packer.l_buf), dtype=torch.uint8,
                            device=dev),
                torch.ones((S, B), dtype=torch.bool, device=dev),
                torch.zeros((S, B), dtype=torch.int32, device=dev),
                enum_ops.zero_carry(B, dev))
        packer = windows.WindowPacker(p.k, p.m, B, l_out=self.window)
        fl = next(packer.pack_flat(iter([np.zeros(p.k, np.uint8)]), S))
        return "flat", self._flat_static(packer), tuple(
            torch.from_numpy(x).to(dev) for x in (
                fl.chunk4, fl.valid_start.reshape(S, B),
                fl.valid_end.reshape(S, B))) + (pipeline.zero_chain(dev),)

    def insert_file(self, path: str) -> None:
        with spans.call("insert_file"):
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
        window lanes itself. k > 32 takes the exact streaming path
        instead (the truncation quirk starves the windowed certificate)."""
        import queue
        if self.params.k > 32:
            self._insert_streaming(records)
            return
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
        ctx = spans.context()

        def staged(fl):
            return (fl, torch.from_numpy(fl.chunk4).to(dev),
                    torch.from_numpy(fl.valid_start.reshape(S, B)).to(dev),
                    torch.from_numpy(fl.valid_end.reshape(S, B)).to(dev))

        def producer():
            spans.adopt(ctx)
            try:
                # a pack span each: one flush packed and staged
                for item in spans.iterate(
                        "pack", map(staged, packer.pack_flat(records, S))):
                    q.put(item)
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

    def _insert_streaming(self, records) -> None:
        """k > 32: one record per lane, exact device-resident carry
        across batches and flushes, fused row appends; no certificates
        and no repairs. The lane length follows the p90 record length."""
        p = self.params
        with spans.span("pack"):
            records = list(records)
            lens = sorted(len(r) for r in records if len(r) >= p.k)
        rec_len = lens[max(0, int(0.9 * len(lens)) - 1)] if lens else None
        packer = self._stream_geometry(rec_len)
        if rec_len is not None and rec_len <= packer.l_buf:
            # short-read fast path: records that fit one lane buffer are
            # laid out with one vectorized fancy-index store per batch
            # instead of BatchPacker's per-record lane loop
            shorts, longs = [], []
            with spans.span("pack"):
                for r in records:
                    if len(r) < p.k:
                        continue
                    if isinstance(r, str):
                        r = fasta.chunk_codes(r)
                    (shorts if len(r) <= packer.l_buf else longs).append(r)

            def batches():
                B, l_buf = self.batch, packer.l_buf
                if shorts:
                    slens = np.array([len(r) for r in shorts],
                                     dtype=np.int64)
                    flat = np.concatenate(shorts)
                    starts = np.zeros(len(shorts) + 1, dtype=np.int64)
                    np.cumsum(slens, out=starts[1:])
                    for g0 in range(0, len(shorts), B):
                        g1 = min(g0 + B, len(shorts))
                        lg = slens[g0:g1]
                        codes = np.zeros((B, l_buf), dtype=np.uint8)
                        lane = np.repeat(
                            np.arange(g1 - g0, dtype=np.int64), lg)
                        within = (np.arange(int(lg.sum()), dtype=np.int64)
                                  - np.repeat(starts[g0:g1] - starts[g0],
                                              lg))
                        codes.reshape(-1)[lane * l_buf + within] = \
                            flat[starts[g0]:starts[g1]]
                        ve = np.zeros(B, dtype=np.int32)
                        ve[:g1 - g0] = lg
                        yield fasta.Batch(codes, np.ones(B, dtype=bool),
                                          ve, int((lg - p.k + 1).sum()))
                if longs:
                    yield from packer.pack(iter(longs))

            self._insert_stream_batches(packer, batches())
            return
        self._insert_stream_batches(packer, packer.pack(iter(records)))

    def _insert_stream_batches(self, packer, batch_iter) -> None:
        """Flush an iterator of fasta.Batch through the streaming program,
        a stack of `stack` batches per flush (the tail padded with fresh
        empty lanes)."""
        p = self.params
        S, B = self.stack, self.batch
        row_cap = packer.l_new  # full width: segmentation cannot overflow
        dev = self.device
        carry = enum_ops.zero_carry(B, dev)
        flush_rows = S * B * row_cap

        def flush(batches):
            nonlocal carry
            if self._rows_ub + flush_rows > self.skl.bucket.shape[0]:
                self._settle_counts()
                with spans.span("readback"):
                    self._rows_ub = int(self.skl.n_rows)
                self.skl = sklstore.ensure_room(self.skl, flush_rows)

            def stacked(field):
                return torch.from_numpy(np.stack(
                    [getattr(bt, field) for bt in batches])).to(dev)

            with spans.span("pack"):
                staged = [stacked(f) for f in ("codes", "fresh",
                                               "valid_end")]
            with spans.span("flush"):
                (self.skl, n_sk, n_km, carry,
                 _) = flush_graph.insert_stream(
                    self.skl, *staged, carry, p.k, p.m, p.b, row_cap)
            self._count_acc.append((n_sk, n_km, 0))
            self._rows_ub += flush_rows
            self._dirty = True
            self._expanded = None

        pending = []
        for bt in spans.iterate("pack", batch_iter):
            pending.append(bt)
            if len(pending) == S:
                flush(pending)
                pending = []
        if pending:
            while len(pending) < S:
                pending.append(fasta.Batch(
                    np.zeros((B, packer.l_buf), np.uint8),
                    np.ones(B, dtype=bool), np.zeros(B, np.int32), 0))
            flush(pending)
        self._drain()

    def _dispatch_flush(self, packer, flush, chunk4_d, vs_d, ve_d) -> None:
        """Launch one staged flush; its bookkeeping (counters, repairs,
        overflow re-runs) is deferred to _retire."""
        flush_rows = self.stack * self.batch * self.skl_row_cap
        if self._rows_ub + flush_rows > self.skl.bucket.shape[0]:
            self._drain()  # exact n_rows; grow only if truly needed
            self.skl = sklstore.ensure_room(self.skl, flush_rows)
        with spans.span("flush"):
            (self.skl, n_sk, n_km, flags, ends,
             _, self._chain) = flush_graph.insert_flat(
                self.skl, chunk4_d, vs_d, ve_d, self._chain,
                *self._flat_static(packer))
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
            with spans.span("readback"):
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
        with spans.span("readback"):
            self._rows_ub = int(self.skl.n_rows)

    def _settle_counts(self) -> None:
        """Fold deferred per-flush counter scalars in one copy."""
        if not self._count_acc:
            return
        with spans.span("readback"):
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

        if flags_np is None:
            with spans.span("readback"):
                flags_np = rec["flags"].cpu().numpy()
        flags = flags_np.reshape(-1)
        cert_f = (flags & 1).astype(bool)
        rec_f = flush.rec
        win_f = flush.win
        failed = np.nonzero((~cert_f) & (rec_f >= 0))[0]
        repaired_ends = {}
        ends_cache = []

        def ends_f():
            """Per-lane end states, copied to the host lazily."""
            if not ends_cache:
                with spans.span("readback"):
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
                with spans.span("repair"):
                    e7 = self._repair_window_unchained(flush, j0)
                repaired_ends[j0] = e7
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
            with spans.span("repair"):
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
            with spans.span("repair"):
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
        return end_states(em, [int(ve1[0])], [0], p.k, p.m)[0]

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
        return end_states(em, ve, range(R), p.k, p.m)

    # -- finalization ------------------------------------------------------

    def finalize(self) -> None:
        """Consolidate the fresh rows of the arena into a new
        bucket-grouped segment (sklstore.finalize_device)."""
        with spans.call("finalize"):
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
        """Whole-arena maintenance: merge every segment into one
        bucket-grouped run, fold cross-segment duplicate counts onto one
        slot, drop dead rows (sklstore.consolidate_all). O(n_rows)
        working memory; automatic under consolidate_max_rows, callable
        any time."""
        p = self.params
        self._drain()
        self.skl = sklstore.consolidate_all(self.skl, p.k, p.m, p.b)
        nfr = int(self.skl.n_fin_rows)
        self._skl_segments = [(0, nfr)] if nfr else []
        self._rows_ub = nfr
        self._n_fin_host = nfr
        self._host_cache = None
        self._expanded = None
        self._dirty = False

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
        with spans.call("query_file"):
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
        """Grow minimizer/bucket space: m += 2, b += 2, re-key every
        stored entry under the new minimizer decomposition (reference
        Brisk::reallocate, Brisk.hpp:202-224). As in brisk_tpu, b is
        clamped at 15 (the routing tables are sized 4^b); counts and
        lookups stay exact."""
        from brisk_tpu_torch.index import rekey
        new_params = Parameters(k=self.params.k, m=self.params.m + 2,
                                b=min(self.params.b + 2, 15))
        old = self._expanded_view()
        new_state = rekey.reindex(old, self.params, new_params)
        # super-k-mer grouping is invalid under the new (m, b): one
        # size-1 row per entry, in packed-key (bucket-major) order
        self.skl = sklstore.from_entries(new_state, new_params.k,
                                         new_params.m, new_params.b)
        self._expanded = None
        self._rows_ub = int(self.skl.n_rows)
        self._n_fin_host = int(self.skl.n_fin_rows)
        self._skl_segments = [(0, self._n_fin_host)]
        self._host_cache = None
        self.params = new_params

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Native checkpoint: the arena columns as uint32 and the params,
        under brisk_tpu's .npz keys (brisk_tpu.api.Brisk.load reads it)."""
        self._ensure_final()
        cols = sklstore.to_numpy(self.skl)
        np.savez_compressed(
            path,
            k=self.params.k, m=self.params.m, b=self.params.b,
            n_emitted=self.n_emitted, n_superkmers=self.n_superkmers,
            skl_bucket=cols["bucket"], skl_meta=cols["meta"],
            skl_nucs=cols["nucs"], skl_data=cols["data"],
            skl_offs=cols["offs"],
            skl_n=np.array([cols["n_rows"], cols["n_fin_rows"],
                            cols["n_fin_kmers"]]),
            skl_segments=np.asarray(self._skl_segments,
                                    dtype=np.int64).reshape(-1, 2))

    @classmethod
    def load(cls, path: str, batch: int = 512, window: int = 512,
             device="cuda") -> "Brisk":
        """Load a super-k-mer-arena checkpoint written by either
        package's Brisk.save onto `device` (the first CUDA card unless
        given)."""
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
        else:  # no run list in the file: rebuild it from the buckets
            self._skl_segments = sklstore.runs_from_bucket(z["skl_bucket"],
                                                           nfr)
        self.n_emitted = int(z["n_emitted"])
        self.n_superkmers = int(z["n_superkmers"])
        return self
