"""The counter's workflow on the sharded index, as a closed loop of jobs
(one client).

A job builds a fresh 8-shard index from the input FASTA and queries it
once: `ShardedBrisk(...)` -> `insert_file` -> `finalize` (the build),
then `query_file` of the query reads. The inputs, the end-to-end metrics,
the control and five of the six compared numbers are count_job's: the
same input gives the same answers whatever the layout of the index.

prepare: the inputs (count_job.make_inputs), the kernels and one
warm-up job, which captures the sharded step's graph.
job: one job, timed by the benchmark's spans.
check: after the window, the last job's index read out shard by shard
(every shard's entries, a key held by two shards once per shard, summed
per key by the comparison) against the reference's canonical counts and
counts per key; every job's k-mer total and query total against the
reference's; and the layout: `owner_gap`, the entries that lie on a
shard other than their owner (bucket mod the shard count) beyond what
the rows the index reports as spilled can hold.
metrics, control: count_job's.
trace_facts: the traced job, and the spill and per-shard row counts and
the resident bytes per k-mer of ShardedBrisk.stats().
"""

import atexit
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.reference import compare, fasta, keying, kmers
from benchmark.traffic import count_job

metrics = count_job.metrics
control = count_job.control


def _new_index(st):
    from brisk_tpu_torch.parallel.facade import ShardedBrisk
    from brisk_tpu_torch.params import Parameters
    p, g = st.cfg["params"], st.cfg["geometry"]
    return ShardedBrisk(Parameters(p["k"], p["m"], p["b"]),
                        n_devices=g["n_shards"],
                        batch_per_shard=g["batch_per_shard"],
                        window=g["window"], stack=g["stack"],
                        skl_route_cap=g.get("skl_route_cap"),
                        device=st.dev)


def prepare(cell, seed: int, dev: torch.device) -> count_job.State:
    st = count_job.State()
    st.cfg, st.traffic, st.limits = (cell.config, cell.workload["traffic"],
                                     cell.workload["limits"])
    st.dev = dev
    st.workdir = tempfile.mkdtemp(prefix="brisk-bench-")
    atexit.register(shutil.rmtree, st.workdir, True)
    st.inputs = count_job.make_inputs(st.cfg, st.traffic, seed, st.workdir)
    st.last = None
    if dev.type == "cuda":
        from brisk_tpu_torch import kernels
        kernels.build()
    from benchmark.tracing import Spans
    job(st, Spans(lambda: count_job._sync(dev)))  # the warm-up job
    st.last = None
    return st


def job(st, span) -> dict:
    st.last = None  # the previous job's index goes before this one's
    with span("build"):
        b = _new_index(st)
        with span("insert"):
            b.insert_file(st.inputs["index"])
        with span("finalize"):
            b.finalize()
    with span("query"):
        total = b.query_file(st.inputs["query"])
    st.last = b
    return dict(build_s=span.seconds["build"], query_s=span.seconds["query"],
                n_emitted=int(b.n_emitted),
                n_superkmers=int(b.n_superkmers), query_total=int(total))


def trace_facts(st, jobs: list) -> dict:
    """What the readers need besides the trace: the configuration, the
    traced job's counts and, outside the window, ShardedBrisk.stats()'s
    spilled rows, rows per shard and resident bytes per k-mer. They are
    read of the last job's index, which the same input and geometry make
    equal to the traced job's."""
    s = st.last.stats()
    return dict(config=st.cfg, job=jobs[1], n_spilled=int(s["n_spilled"]),
                shard_entries=[int(v) for v in s["shard_entries"].values()],
                arena_bytes_per_kmer=float(s["bytes_per_kmer"]))


def read_index(b) -> tuple:
    """Every shard's entries as ShardedBrisk.items reads them
    (readout.entries_u64 of each shard's expanded view), in bulk and
    concatenated: (hi, lo, mini_idx, counts) numpy arrays, and the number
    of entries that lie on a shard other than their bucket's owner
    (bucket mod the shard count). A key that lies on its owner shard and
    on a spill shard comes once per shard."""
    from brisk_tpu_torch.index import readout, sklstore
    b.finalize()
    p = b.params
    parts, off_owner = [], 0
    for d, lskl in b._local_skl():
        view = sklstore.expanded_state(lskl, p.k, p.m, p.b)
        bucket, *cols = readout.entries_u64(view, p)
        del view
        off_owner += int(np.count_nonzero(bucket % b.n_shards != d))
        parts.append(cols)
    return (*(np.concatenate(col) for col in zip(*parts)), off_owner)


def check(st, jobs: list) -> tuple:
    """Compare, after the window, and free what the run made. Returns
    ({number: dict(value, limit)}, failed jobs). The first five numbers
    and their reference are count_job.check's; the index's counts are
    summed per key across shards (compare.content_mismatch). owner_gap:
    a spilled row holds at most 2 (k - m) + 1 k-mers (a minimizer's
    super-k-mer), so entries off their owner shard beyond that many a
    spilled row were never routed."""
    k, m = st.cfg["params"]["k"], st.cfg["params"]["m"]
    dev = st.dev
    t0 = time.perf_counter()

    def lap(what):
        print(f"{what} {time.perf_counter() - t0:.3f} s", file=sys.stderr)

    hi, lo, idx, cnt, off_owner = read_index(st.last)
    owner_gap = max(0, off_owner - st.last.n_spilled * (2 * (k - m) + 1))
    lap("read-out")
    st.last = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        codes = torch.from_numpy(fasta.read_codes(st.inputs["index"])
                                 ).to(dev)
        ref_words, ref_counts, total = kmers.count_canonical(codes, k)
        ref_keys, ref_key_counts, _ = kmers.count_words(compare.key_words(
            *keying.emission_keys(codes, k, m), k))
        del codes
        lap("reference counted")
        limbs = compare.limbs_from_u64(hi, lo, k, dev)
        del hi, lo
        counts = torch.from_numpy(cnt.astype(np.int64)).to(dev)
        entry_idx = torch.from_numpy(idx.astype(np.int64)).to(dev)
        content = compare.content_mismatch(
            ref_words, ref_counts,
            kmers.pack_words(kmers.limb_fields(
                compare.canonical_limbs(limbs, k), k)), counts)
        del ref_words, ref_counts
        keyed = compare.content_mismatch(
            ref_keys, ref_key_counts,
            compare.key_words(limbs, entry_idx, k), counts)
        del limbs, entry_idx, counts
        st.ref_distinct = content["ref_distinct"]
        qcodes = torch.from_numpy(fasta.read_codes(st.inputs["query"])
                                  ).to(dev)
        expected = compare.query_expected(
            ref_keys, ref_key_counts, compare.key_words(
                *keying.emission_keys(qcodes, k, m), k))
        lap("compared")
    finally:
        shutil.rmtree(st.workdir, ignore_errors=True)
    bad = [j for j in jobs if j["n_emitted"] != total
           or j["query_total"] != expected]
    wrong_index = content["mismatch"] or keyed["mismatch"] or owner_gap
    failed = len(bad) + (1 if wrong_index and jobs[-1] not in bad else 0)
    values = dict(
        emitted_gap=max(abs(j["n_emitted"] - total) for j in jobs),
        count_mismatch=content["mismatch"],
        key_mismatch=keyed["mismatch"],
        distinct_gap=abs(content["sys_distinct"] - content["ref_distinct"]),
        query_gap=max(abs(j["query_total"] - expected) for j in jobs),
        owner_gap=owner_gap)
    return {n: dict(value=v, limit=st.limits[n])
            for n, v in values.items()}, failed
