"""The plain reference against brute-force Python on small inputs: the
canonical counter (break splits, reverse complements, counts past 256),
the keys of query emissions (the frozen oracle), the query total and the
content comparison."""

import numpy as np
import pytest
import torch

from benchmark.reference import compare, control, fasta, keying, kmers
from benchmark.reference import pyref_frozen as pr

RC = str.maketrans("ACGT", "TGCA")


def rc(s):
    return s.translate(RC)[::-1]


def codes_of(text):
    return torch.from_numpy(fasta._TABLE[np.frombuffer(text.encode(),
                                                       np.uint8)])


def value(s):
    v = 0
    for ch in s:
        v = (v << 2) | ((ord(ch) >> 1) & 3)
    return v


def brute(text, k):
    d = {}
    for chunk in pr.clean_chunks(text):
        for i in range(len(chunk) - k + 1):
            x = chunk[i:i + k]
            c = min(value(x), value(rc(x)))
            d[c] = d.get(c, 0) + 1
    return d


def words_to_ints(words, k):
    """Values from pack_words words: the limb fields are packed whole,
    most significant first, into words of at most 62 bits."""
    widths = [2 * min(16, k - 16 * t)
              for t in reversed(range(kmers.n_limbs(k)))]
    groups, bits = [], 63
    for wd in widths:
        if bits + wd <= 62:
            groups[-1] += wd
            bits += wd
        else:
            groups.append(wd)
            bits = wd
    out = []
    for i in range(words[0].shape[0]):
        v = 0
        for w, g in zip(words, groups):
            v = (v << g) | int(w[i])
        out.append(v)
    return out


@pytest.mark.parametrize("k", [5, 21, 31, 63])
def test_canonical_counts_equal_brute_force(k):
    rng = np.random.default_rng(k)
    parts = []
    for i in range(12):
        s = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 300))))
        parts.append(s if i % 3 else rc(s))
    text = "NN".join(parts) + "acgtN" + parts[0][:80].lower()
    want = brute(text, k)
    words, counts, total = kmers.count_canonical(codes_of(text), k)
    got = dict(zip(words_to_ints(words, k), counts.tolist()))
    assert got == want
    assert total == sum(want.values()) == fasta.n_kmers(
        codes_of(text).numpy(), k)


def test_counts_wrap_past_256():
    unit = "ACGTTGCAAGT"
    text = unit * 400
    words, counts, _ = kmers.count_canonical(codes_of(text), 5)
    want = brute(text, 5)
    assert max(want.values()) > 256
    assert dict(zip(words_to_ints(words, 5), counts.tolist())) == want
    res = compare.content_mismatch(words, counts, words, counts % 256)
    assert res["mismatch"] == 0


SHORT, LONG = "short reads", "long chunks cut into pieces"


@pytest.mark.parametrize("k,m,kind", [
    (31, 11, SHORT), (63, 21, SHORT), (21, 11, SHORT),
    (31, 15, LONG), (31, 11, LONG), (63, 21, LONG)])
def test_emission_keys_match_the_oracle(k, m, kind):
    rng = np.random.default_rng(k + m)
    dede = pr.DecyclingSet(m)
    if kind == SHORT:
        reads = ["".join("ACGT"[x] for x in rng.integers(
            0, 4 if i % 3 else 2, int(rng.integers(k, 170))))
            for i in range(40)]
        pieces = {}
    else:
        reads = ["".join("ACGT"[x] for x in rng.integers(0, 4, n))
                 for n in (3000, 700, k, k + 5, 2500)]
        pieces = dict(piece=300, overlap=200, block=4000)
    text = "".join(">r\n" + r + "\n" for r in reads)
    limbs, idx = keying.emission_keys(torch.from_numpy(
        fasta.read_codes_bytes(text.encode())), k, m, **pieces)
    want = [(rec.kmer, rec.minimizer_idx) for r in reads
            for rec, _, _ in pr.scan_emissions(r, k, m, dede)]
    got = [(sum(int(limbs[t][i]) << (32 * t) for t in range(len(limbs))),
            int(idx[i])) for i in range(idx.shape[0])]
    assert got == want


def test_pieces_that_never_meet_raise():
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 4, 20000).astype(np.uint8))
    with pytest.raises(RuntimeError, match="never met"):
        keying.emission_keys(codes, 63, 21, piece=200, overlap=1)


def test_key_mismatch_sees_counts_moved_between_keys():
    # one canonical k-mer under two keys: the canonical sums agree, the
    # counts per key do not
    limbs = (torch.tensor([7, 7]), torch.tensor([1, 1]))
    ref = compare.key_words(limbs, torch.tensor([3, 5]), 31)
    sys_ = compare.key_words(limbs, torch.tensor([3, 5]), 31)
    res = compare.content_mismatch(ref, torch.tensor([2, 1]), sys_,
                                   torch.tensor([1, 2]))
    assert res["mismatch"] == 2 and res["sys_distinct"] == 2
    canon = kmers.pack_words(kmers.limb_fields(limbs, 31))
    assert compare.content_mismatch(
        [w[:1] for w in canon], torch.tensor([3]), canon,
        torch.tensor([1, 2]))["mismatch"] == 0


def test_query_expected_equals_brute_sum():
    rng = np.random.default_rng(2)
    n = 500
    entry_limbs = (torch.from_numpy(rng.integers(0, 1 << 32, n)),
                   torch.from_numpy(rng.integers(0, 1 << 30, n)))
    entry_idx = torch.from_numpy(rng.integers(0, 21, n))
    counts = torch.from_numpy(rng.integers(1, 600, n))
    pick = rng.integers(0, n, 300)
    q_limbs = tuple(x[pick] for x in entry_limbs)
    q_idx = entry_idx[pick].clone()
    q_idx[::7] = (q_idx[::7] + 1) % 21  # some keys absent
    table = {}
    for i in range(n):
        key = (int(entry_limbs[0][i]), int(entry_limbs[1][i]),
               int(entry_idx[i]))
        table[key] = table.get(key, 0) + int(counts[i])
    want = sum(table.get((int(q_limbs[0][j]), int(q_limbs[1][j]),
                          int(q_idx[j])), 0) % 256 for j in range(300))
    got = compare.query_expected(compare.key_words(entry_limbs, entry_idx,
                                                   31), counts,
                                 compare.key_words(q_limbs, q_idx, 31))
    assert got == want


def test_content_mismatch_counts_every_difference():
    w = [torch.tensor([1, 2, 3, 4])]
    c = torch.tensor([1, 5, 2, 300])
    sys_w = [torch.tensor([1, 2, 2, 4, 9])]
    sys_c = torch.tensor([1, 2, 3, 44, 1])  # 4: 300 % 256 == 44
    res = compare.content_mismatch(w, c, sys_w, sys_c)
    # 3 missing, 9 extra; 2 is 2 + 3 = 5 (equal), 4 equal mod 256
    assert res == dict(mismatch=2, ref_distinct=4, sys_distinct=4)


def test_canonical_limbs_and_revcomp():
    rng = np.random.default_rng(9)
    for k in (31, 63):
        vals = [int(x) for x in rng.integers(0, 1 << 62, 50)]
        vals = [v | (int(rng.integers(0, 1 << 62)) << 62) if k > 32
                else v for v in vals]
        vals = [v & ((1 << (2 * k)) - 1) for v in vals]
        hi = np.array([v >> 64 for v in vals], np.uint64)
        lo = np.array([v & ((1 << 64) - 1) for v in vals], np.uint64)
        limbs = compare.limbs_from_u64(hi, lo, k, "cpu")
        canon = compare.canonical_limbs(limbs, k)
        for i, v in enumerate(vals):
            s = "".join("ACTG"[(v >> (2 * (k - 1 - j))) & 3]
                        for j in range(k))
            want = min(v, value(rc(s)))
            got = sum(int(canon[t][i]) << (32 * t) for t in range(len(canon)))
            assert got == want


def test_control_merges_colliding_kmers():
    words = [torch.arange(0, 200000, dtype=torch.int64) * 7919]
    counts = torch.ones(200000, dtype=torch.int64)
    cw, cc = control.fingerprint_content(words, counts)
    fp = control.fingerprint(words)
    assert cw[0].shape[0] == torch.unique(fp).shape[0]
    assert int(cc.sum()) == 200000
