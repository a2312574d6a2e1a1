"""The counter's workflow as a closed loop of jobs (one client).

A job builds a fresh index from the input FASTA and queries it once:
`Brisk(...)` -> `insert_file` -> `finalize` (the build), then
`query_file` of the query reads (the counter's -f genome -q reads).

prepare: generate the inputs from the seed (configuration:
index_input; workload: traffic), write them under TMPDIR, build the
program's kernels and run one warm-up job of the cell's own shapes.
job: one job, timed by the benchmark's spans.
check: after the window, the last job's index against the reference's
canonical counts and against its counts per key (the key the counter
stores a k-mer under: its emitted orientation and minimizer position),
every job's k-mer total and query total against the reference's (the
query total from the reference's own keys of the query emissions,
joined with its own counts per key of the index input).
metrics: the end-to-end metrics from the jobs' spans.
"""

import atexit
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.gen import synth
from benchmark.reference import compare, fasta, keying, kmers


class State:
    pass


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _with_breaks(reads: list) -> np.ndarray:
    """Reads as one code array, a break after each (as fasta.read_codes
    gives them)."""
    out = np.full(sum(r.size for r in reads) + len(reads), fasta.BREAK,
                  dtype=np.uint8)
    pos = 0
    for r in reads:
        out[pos:pos + r.size] = r
        pos += r.size + 1
    return out


def make_inputs(cfg: dict, traffic: dict, seed: int, workdir: str) -> dict:
    """Write the index input and the query reads; return their paths and
    k-mer totals."""
    k = cfg["params"]["k"]
    src = cfg["index_input"]
    g_rng, r_rng, q_rng = synth.streams(seed, 3)
    index_path = os.path.join(workdir, "index.fa")
    if src["kind"] == "genome":
        genome = synth.genome(g_rng, src["bases"], src["n_per"])
        synth.write_contig(index_path, genome)
        index_codes = genome
    else:
        genome = synth.genome(g_rng, src["genome_bases"], src["n_per"])
        lengths = synth.hifi_lengths(src["genome_bases"] * src["coverage"],
                                     src["read_min"], src["read_max"])
        reads = synth.sample_reads(r_rng, genome, lengths, src["sub_rate"])
        synth.write_reads(index_path, reads)
        index_codes = _with_breaks(reads)
    q = synth.sample_reads(q_rng, genome,
                           np.full(traffic["query_reads"],
                                   traffic["query_read_len"]),
                           traffic["query_sub_rate"])
    query_path = os.path.join(workdir, "query.fa")
    synth.write_reads(query_path, q, "q")
    for path in (index_path, query_path):
        # on disk in set-up: no write-back of the inputs in the window
        fd = os.open(path, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    return dict(index=index_path, query=query_path,
                index_kmers=fasta.n_kmers(index_codes, k),
                query_kmers=fasta.n_kmers(_with_breaks(q), k))


def _new_index(st):
    from brisk_tpu_torch.api import Brisk
    from brisk_tpu_torch.params import Parameters
    p, g = st.cfg["params"], st.cfg["geometry"]
    b = Brisk(Parameters(p["k"], p["m"], p["b"]), batch=g["batch"],
              window=g["window"], stack=g["stack"], device=st.dev)
    b.segment_rows = g["segment_rows"]
    return b


def prepare(cell, seed: int, dev: torch.device) -> State:
    st = State()
    st.cfg, st.traffic, st.limits = (cell.config, cell.workload["traffic"],
                                     cell.workload["limits"])
    st.dev = dev
    st.workdir = tempfile.mkdtemp(prefix="brisk-bench-")
    atexit.register(shutil.rmtree, st.workdir, True)
    st.inputs = make_inputs(st.cfg, st.traffic, seed, st.workdir)
    st.last = None
    if dev.type == "cuda":
        from brisk_tpu_torch import kernels
        kernels.build()
    from benchmark.tracing import Spans
    job(st, Spans(lambda: _sync(dev)))  # the warm-up job
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


def metrics(st, jobs: list, setup_s: float) -> dict:
    n = len(jobs)
    return dict(
        setup_s=setup_s,
        build_kmers_per_s=n * st.inputs["index_kmers"]
        / sum(j["build_s"] for j in jobs),
        query_kmers_per_s=n * st.inputs["query_kmers"]
        / sum(j["query_s"] for j in jobs),
        peak_bytes_per_kmer=max(j["peak_bytes"] for j in jobs)
        / st.ref_distinct)


def trace_facts(st, jobs: list) -> dict:
    """What the readers need besides the trace: the configuration, the
    traced job's counts and, outside the window, the arena's resident
    bytes per k-mer (Brisk.stats)."""
    return dict(config=st.cfg, job=jobs[1],
                arena_bytes_per_kmer=float(
                    st.last.stats()["bytes_per_kmer"]))


def read_index(b) -> tuple:
    """The program's index as Brisk.items reads it out
    (readout.entries_u64 of the finalized view), in bulk: (hi, lo,
    mini_idx, counts) numpy arrays. Brisk.items itself yields a Python
    int per entry, far too slow for a chromosome's 249 M."""
    from brisk_tpu_torch.index import readout
    _, hi, lo, idx, cnt = readout.entries_u64(b._expanded_view(), b.params)
    return hi, lo, idx, cnt


def check(st, jobs: list) -> tuple:
    """Compare, after the window, and free what the run made. Returns
    ({number: dict(value, limit)}, failed jobs)."""
    k, m = st.cfg["params"]["k"], st.cfg["params"]["m"]
    dev = st.dev
    t0 = time.perf_counter()

    def lap(what):
        print(f"{what} {time.perf_counter() - t0:.3f} s", file=sys.stderr)

    hi, lo, idx, cnt = read_index(st.last)
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
    wrong_index = content["mismatch"] or keyed["mismatch"]
    failed = len(bad) + (1 if wrong_index and jobs[-1] not in bad else 0)
    values = dict(
        emitted_gap=max(abs(j["n_emitted"] - total) for j in jobs),
        count_mismatch=content["mismatch"],
        key_mismatch=keyed["mismatch"],
        distinct_gap=abs(content["sys_distinct"] - content["ref_distinct"]),
        query_gap=max(abs(j["query_total"] - expected) for j in jobs))
    return {n: dict(value=v, limit=st.limits[n])
            for n, v in values.items()}, failed


def control(cell, seed: int, dev: torch.device) -> dict:
    """The control's numbers (reference/control.py) on this cell's inputs
    for `seed`, at the cell's own size."""
    from benchmark.reference import control as ctl
    workdir = tempfile.mkdtemp(prefix="brisk-control-")
    try:
        inputs = make_inputs(cell.config, cell.workload["traffic"], seed,
                             workdir)
        return ctl.readings(inputs["index"], cell.config["params"]["k"], dev)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
