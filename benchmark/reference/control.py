"""The control: the reference put in the program's place with one of the
configuration's guarantees broken, which the comparison has to fail.

The guarantee broken is exact counts: the control keys each canonical
k-mer by a 32-bit fingerprint instead of its 2k bits (the step down a
later change to the index's keys could take), so k-mers whose
fingerprints collide share one count. Its content goes through the same
content_mismatch as the program's index.
"""

import torch

from benchmark.reference import compare, fasta, kmers

M32 = 0xFFFFFFFF
_MUL = 0x5BD1E995


def fingerprint(words: list) -> torch.Tensor:
    """A 32-bit fingerprint of multi-word keys (each word <= 62 bits;
    every product stays under 2^63)."""
    h = torch.zeros_like(words[0])
    for w in words:
        for part in (w & 0x7FFFFFFF, (w >> 31) & 0x7FFFFFFF):
            h = ((h ^ part) * _MUL) & M32
            h = h ^ (h >> 15)
    return h


def fingerprint_content(ref_words: list, ref_counts: torch.Tensor) -> tuple:
    """The control's index: per fingerprint, the smallest of its k-mers
    with the summed count of all of them."""
    fp = fingerprint(ref_words)
    perm = kmers.lexsort([fp] + list(ref_words))
    fp, words = fp[perm], [w[perm] for w in ref_words]
    first = kmers.run_starts([fp])
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    sums = torch.zeros(int(run[-1]) + 1, dtype=torch.int64,
                       device=fp.device)
    sums.index_add_(0, run, ref_counts[perm])
    return [w[first] for w in words], sums


def readings(index_path: str, k: int, dev) -> dict:
    """The comparison's numbers for the control on one input."""
    codes = torch.from_numpy(fasta.read_codes(index_path)).to(dev)
    ref_words, ref_counts, _ = kmers.count_canonical(codes, k)
    del codes
    c_words, c_counts = fingerprint_content(ref_words, ref_counts)
    res = compare.content_mismatch(ref_words, ref_counts, c_words, c_counts)
    return dict(count_mismatch=res["mismatch"],
                distinct_gap=abs(res["sys_distinct"] - res["ref_distinct"]),
                ref_distinct=res["ref_distinct"])
