"""The comparisons that decide `correct`, in plain PyTorch.

content_mismatch: an index's counts against the reference's, per key:
per canonical k-mer, or per the counter's own key (the emitted
orientation and minimizer position, keying.py). One canonical k-mer can
lie under several entries; their counts are summed, mod 256, per key.

query_expected: the total a query join must give: for every query
emission, the count stored under its key, mod 256, summed (the
counter's query_fasta, counter.cpp:314-346).
"""

import numpy as np
import torch

from benchmark.reference import kmers


def limbs_from_u64(hi: np.ndarray, lo: np.ndarray, k: int, device) -> tuple:
    """Limbs (low first) of k-mer values given as uint64 (hi, lo) halves
    of the 2k-bit value."""
    out = []
    for t in range(kmers.n_limbs(k)):
        half = lo if t < 2 else hi
        x = torch.from_numpy(np.ascontiguousarray(half).view(np.int64)
                             ).to(device)
        out.append((x >> (32 * (t % 2))) & kmers.M32)
    return tuple(out)


def canonical_limbs(limbs: tuple, k: int, chunk: int = 1 << 25) -> tuple:
    """Canonical forms of k-mer values given as limbs, in chunks."""
    n = limbs[0].shape[0]
    if not n:
        return tuple(limbs)
    parts = []
    for a in range(0, n, chunk):
        part = tuple(x[a:a + chunk] for x in limbs)
        parts.append(kmers.canonical(part, kmers.revcomp_limbs(part, k)))
    return tuple(torch.cat([p[t] for p in parts])
                 for t in range(len(limbs)))


def _merge(words_a: list, words_b: list) -> tuple:
    """Sort the columns of two keyed sets together; returns (permutation
    of the concatenation, run id of each sorted column, number of runs,
    bool: sorted column comes from b)."""
    words = [torch.cat([a, b]) for a, b in zip(words_a, words_b)]
    from_b = torch.cat([torch.zeros(words_a[0].shape[0], dtype=torch.bool,
                                    device=words[0].device),
                        torch.ones(words_b[0].shape[0], dtype=torch.bool,
                                   device=words[0].device)])
    perm = kmers.lexsort(words)
    first = kmers.run_starts([w[perm] for w in words])
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    n_runs = int(run[-1]) + 1 if run.numel() else 0
    return perm, run, n_runs, from_b[perm]


def content_mismatch(ref_words: list, ref_counts: torch.Tensor,
                     sys_words: list, sys_counts: torch.Tensor) -> dict:
    """Keys whose count mod 256 differs between the reference (one column
    per distinct key) and the system (any number of columns per key),
    those on one side only included; and the distinct totals of both
    sides."""
    perm, run, n_runs, from_sys = _merge(ref_words, sys_words)
    counts = torch.cat([ref_counts, sys_counts]).to(torch.int64)[perm]
    dev = counts.device
    ref_c = torch.zeros(n_runs, dtype=torch.int64, device=dev)
    sys_c = torch.zeros_like(ref_c)
    ref_has = torch.zeros(n_runs, dtype=torch.bool, device=dev)
    sys_has = torch.zeros_like(ref_has)
    ref_c.index_add_(0, run[~from_sys], counts[~from_sys])
    sys_c.index_add_(0, run[from_sys], counts[from_sys])
    ref_has[run[~from_sys]] = True
    sys_has[run[from_sys]] = True
    bad = (ref_has != sys_has) | (ref_c % 256 != sys_c % 256)
    return dict(mismatch=int(bad.sum()), ref_distinct=int(ref_has.sum()),
                sys_distinct=int(sys_has.sum()))


def key_words(limbs: tuple, idx: torch.Tensor, k: int) -> list:
    """An emission key (emitted k-mer, minimizer position) as words."""
    return kmers.pack_words(kmers.limb_fields(limbs, k) + [(idx, 6)])


def query_expected(entry_words: list, entry_counts: torch.Tensor,
                   query_words: list) -> int:
    """Sum over the query keys of the count stored under each (the sum
    of the entries with that key), mod 256."""
    perm, run, n_runs, from_q = _merge(entry_words, query_words)
    counts = torch.cat([entry_counts.to(torch.int64),
                        torch.zeros(query_words[0].shape[0],
                                    dtype=torch.int64,
                                    device=entry_counts.device)])[perm]
    per_run = torch.zeros(n_runs, dtype=torch.int64, device=counts.device)
    per_run.index_add_(0, run[~from_q], counts[~from_q])
    return int((per_run[run[from_q]] % 256).sum())
