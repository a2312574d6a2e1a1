"""Frozen copy of brisk_tpu_torch/oracle/pyref.py at commit 44e47b2 (the
exact pure-Python statement of the Brisk counter's semantics), kept for
the benchmark's CPU tests: the plain reference is held to it on small
inputs. Nothing at run time imports it.

Exact pure-Python oracle of the reference Brisk k-mer semantics.

Every function here is a bit-exact, arbitrary-precision-int re-statement of
the cited reference behavior (file:line cites refer to the reference C++
sources). This module is the ground truth that the vectorized JAX ops are tested
against; it is itself validated against golden dumps produced by the
compiled reference sources (tests/ref_harness/golden_dump.cpp).

Deliberately replicated quirks (do NOT "fix" these — parity depends on them):

* ``rcb128`` (reference Kmers.cpp:293-316): the SSE byte-swap result is
  DISCARDED (`_mm_shuffle_epi8(...)` at Kmers.cpp:304 is not assigned), so
  the "128-bit reverse complement" only reverses nucleotides *within each
  byte of each 64-bit half* before complementing and right-aligning. It is
  not a true reverse complement. It feeds only ``canonized_k`` (the
  tie-break strand test in get_minimizer, Kmers.cpp:399).
* ``get_minimizer`` equal-hash tie-breaks (Kmers.cpp:389-404): on an equal
  hash with a strictly closer-to-edge mirror position the new position is
  recorded as ``k - m - i`` (distance from the LEFT edge), and on the
  equal-distance branch ``reversed`` is forced to False and ``hash_mini``
  is not rewritten.
* Rolling strand flag (Kmers.cpp:576): ``reversed = (canon == rc)`` — a
  palindromic m-mer counts as reversed on the rolling path but as forward
  (``mini != fwd`` is False) inside ``get_minimizer`` (Kmers.cpp:374).
"""

import functools
import math
from dataclasses import dataclass
from typing import Iterator, List, Tuple

# ---------------------------------------------------------------------------
# C1: 2-bit codec (reference Kmers.cpp:246-253, 218-242, 442-450)
# A=0, C=1, T=2, G=3 (value = (ascii >> 1) & 3); complement = value ^ 2.
# ---------------------------------------------------------------------------

_NUC = "ACTG"  # value -> char (index i encodes value i)


def nuc2int(c: str) -> int:
    return (ord(c) >> 1) & 3


def str2num(s: str) -> int:
    res = 0
    for c in s:
        res = (res << 2) | nuc2int(c)
    return res


def num2str(num: int, k: int) -> str:
    num &= (1 << (2 * k)) - 1
    return "".join(_NUC[(num >> (2 * (k - 1 - i))) & 3] for i in range(k))


# ---------------------------------------------------------------------------
# C2: reverse complement / canonicalization
# ---------------------------------------------------------------------------

def rcb64(x: int, n: int) -> int:
    """True reverse complement of an n-base (n<=32) 2-bit word
    (reference rcbc, Kmers.cpp:320-332)."""
    assert n <= 32
    x &= (1 << 64) - 1
    res = x ^ 0xAAAAAAAAAAAAAAAA
    # byte swap
    res = int.from_bytes(res.to_bytes(8, "little"), "big")
    c1 = 0x0F0F0F0F0F0F0F0F
    c2 = 0x3333333333333333
    res = ((res & c1) << 4) | ((res & (c1 << 4)) >> 4)
    res = ((res & c2) << 2) | ((res & (c2 << 2)) >> 2)
    res &= (1 << 64) - 1
    return res >> (64 - 2 * n)


def rcb128_broken(x: int, n: int) -> int:
    """The reference's 128-bit "reverse complement" with its discarded
    byte-swap (Kmers.cpp:293-316). Reverses nucleotide order only within
    each byte of each 64-bit half, complements, then shifts right to
    realign n bases."""
    lo = x & ((1 << 64) - 1)
    hi = (x >> 64) & ((1 << 64) - 1)
    c1 = 0x0F0F0F0F0F0F0F0F
    c2 = 0x3333333333333333

    def half(v: int) -> int:
        v = (((v & c1) << 4) | ((v & (c1 << 4)) >> 4)) & ((1 << 64) - 1)
        v = (((v & c2) << 2) | ((v & (c2 << 2)) >> 2)) & ((1 << 64) - 1)
        return v ^ 0xAAAAAAAAAAAAAAAA

    combined = (half(hi) << 64) | half(lo)
    return combined >> (128 - 2 * n)


def canonize64(x: int, n: int) -> int:
    return min(x, rcb64(x, n))


def canonized_k(x: int, k: int) -> bool:
    """Strand test on the full k-mer via the broken 128-bit RC
    (reference canonized, Kmers.cpp:348-353)."""
    return x <= rcb128_broken(x, k)


def revcomp(x: int, n: int) -> int:
    """TRUE reverse complement for any n (used for rolling RC values)."""
    out = 0
    for i in range(n):
        out = (out << 2) | (((x >> (2 * i)) & 3) ^ 2)
    return out


# ---------------------------------------------------------------------------
# C4: Decycling set (reference Decycling.cpp:7-52); coef built for size m.
# ---------------------------------------------------------------------------

class DecyclingSet:
    def __init__(self, m: int):
        self.m = m
        self.unit = 2 * math.pi / m
        # coef[4*i + v] = v * sin(unit * i) for i in 1..m-1; coef[0..3] = 0
        self.coef = [0.0] * (4 * m)
        for i in range(4, 4 * m, 4):
            s = math.sin(self.unit * (i // 4))
            self.coef[i + 1] = s
            self.coef[i + 2] = 2 * s
            self.coef[i + 3] = 3 * s
        self.eps = 0.000001

    def compute_r(self, seq: int) -> float:
        r = 0.0
        i = 4 * (self.m - 1)
        while i > 0:
            r += self.coef[i + (seq & 3)]
            seq >>= 2
            i -= 4
        return r

    def mem_double(self, seq: int) -> int:
        """Class in {0: decycling set, 1: double set, 2: other}; class 0
        ranks lowest in the minimizer order via the hash high bits."""
        r = self.compute_r(seq)
        if r > self.eps:
            rot = ((seq & 3) << (2 * (self.m - 1))) + (seq >> 2)
            if self.compute_r(rot) < self.eps:
                return 0
        elif r < -self.eps:
            rot = ((seq & 3) << (2 * (self.m - 1))) + (seq >> 2)
            if self.compute_r(rot) > -self.eps:
                return 1
        return 2


@functools.lru_cache(maxsize=None)
def get_decycling(m: int) -> DecyclingSet:
    """Shared per-m DecyclingSet (scalar lookups used to rebuild the
    sin-coefficient table on every get(); VERDICT r3 item 6)."""
    return DecyclingSet(m)


# ---------------------------------------------------------------------------
# C3: invertible hash (reference hashing.cpp:8-49). The returned value is
# (heavy_class << 62) + mixed_key where mixed_key < 2^(2m) <= 2^62.
# ---------------------------------------------------------------------------

_U64 = (1 << 64) - 1


def bfc_hash_64(key: int, mask: int, dede: DecyclingSet) -> int:
    heavy = dede.mem_double(key)
    key = (~key + (key << 21)) & mask
    key = (key ^ (key >> 24)) & _U64
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = (key ^ (key >> 14)) & _U64
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = (key ^ (key >> 28)) & _U64
    key = (key + (key << 31)) & mask
    return (heavy << 62) + key


def bfc_hash_64_inv(key: int, mask: int) -> int:
    tmp = (key - (key << 21)) & _U64
    key = (key - (tmp << 31)) & mask
    # ^ NOTE: reference first inverts key + (key << 31):
    # tmp = key - (key << 31); key = (key - (tmp << 31)) & mask
    tmp = (key ^ (key >> 28)) & _U64
    key = (key ^ (tmp >> 28)) & _U64
    key = (key * 14933078535860113213) & mask
    tmp = (key ^ (key >> 14)) & _U64
    tmp = (key ^ (tmp >> 14)) & _U64
    tmp = (key ^ (tmp >> 14)) & _U64
    key = (key ^ (tmp >> 14)) & _U64
    key = (key * 15244667743933553977) & mask
    tmp = (key ^ (key >> 24)) & _U64
    key = (key ^ (tmp >> 24)) & _U64
    tmp = (~key) & _U64
    tmp = (~(key - (tmp << 21))) & _U64
    tmp = (~(key - (tmp << 21))) & _U64
    key = (~(key - (tmp << 21))) & mask
    return key


# ---------------------------------------------------------------------------
# C5: minimizer selection (reference get_minimizer, Kmers.cpp:367-408)
# ---------------------------------------------------------------------------

def get_minimizer(seq: int, k: int, m: int, dede: DecyclingSet
                  ) -> Tuple[int, int, bool, int]:
    """Returns (mini, min_position, reversed, hash_mini).

    min_position counts from the suffix (right) end; see module docstring
    for the literal tie-break quirks.

    QUIRK (Kmers.cpp:371): the reference's scan variable is declared
    ``uint64_t cur_seq = seq`` — the k-mer is TRUNCATED to its low 64 bits,
    so for k > 32 every m-mer window beyond base 31 reads zeros. Replicated
    here for parity."""
    m_mask = (1 << (2 * m)) - 1
    fwd = seq & m_mask
    cur = seq & _U64  # uint64_t cur_seq = seq  (truncating!)
    mini = canonize64(fwd, m)
    hash_mini = bfc_hash_64(mini, m_mask, dede)
    reversed_ = mini != fwd
    min_position = 0
    for i in range(1, k - m + 1):
        cur >>= 2
        fwd = cur & m_mask
        mmer = canonize64(fwd, m)
        new_hash = bfc_hash_64(mmer, m_mask, dede)
        if new_hash < hash_mini:
            min_position = i
            mini = mmer
            reversed_ = mini != fwd
            hash_mini = new_hash
        elif new_hash == hash_mini:
            if k - m - i < min_position:
                min_position = k - m - i
                mini = mmer
                reversed_ = mini != fwd
                hash_mini = new_hash
            elif k - m - i == min_position:
                if not canonized_k(seq, k):
                    min_position = k - m - i
                    mini = mmer
                    reversed_ = False
    return mini, min_position, reversed_, hash_mini


# ---------------------------------------------------------------------------
# C7: SuperKmerEnumerator (reference Kmers.cpp:509-613) as a generator of
# super-k-mers. Each yielded super-k-mer is a list of emitted k-mer records.
# ---------------------------------------------------------------------------

@dataclass
class KmerRecord:
    kmer: int           # emitted value (fwd or rc oriented), 2k bits
    minimizer: int      # canonical minimizer value (2m bits)
    minimizer_idx: int  # suffix length: distance of minimizer from right end


def scan_emissions(seq: str, k: int, m: int, dede: DecyclingSet
                   ) -> Iterator[Tuple[KmerRecord, bool, bool]]:
    """Per-position emissions in scan order: yields (record, boundary,
    reversed) for each of the len(seq)-k+1 k-mers. `boundary` means a
    super-k-mer ended just before this k-mer (the reference's to_return
    with seq_idx>0, Kmers.cpp:585-588)."""
    n = len(seq)
    if n < k:
        return
    k_mask = (1 << (2 * k)) - 1
    m_mask = (1 << (2 * m)) - 1

    # init with the first k-1 bases (Kmers.cpp:528-534)
    kmer = str2num(seq[: k - 1])
    rc_kmer = revcomp(kmer, k - 1) << 2
    mini_candidate = str2num(seq[k - m - 1: k - 1]) & (m_mask >> 2)
    rc_mini_candidate = revcomp(str2num(seq[k - m - 1: k - 1]), m)
    mini, mini_pos, reversed_, _ = get_minimizer(kmer, k - 1, m, dede)
    mini_hash = bfc_hash_64(mini, m_mask, dede)

    for seq_idx in range(n - k + 1):
        nuc = nuc2int(seq[k - 1 + seq_idx])
        kmer = ((kmer << 2) | nuc) & k_mask
        rc_kmer = (rc_kmer >> 2) | ((nuc ^ 2) << (2 * k - 2))
        mini_candidate = ((mini_candidate << 2) | nuc) & m_mask
        rc_mini_candidate = (rc_mini_candidate >> 2) | ((nuc ^ 2) << (2 * m - 2))
        mini_pos += 1
        candidate_canon = min(mini_candidate, rc_mini_candidate)
        current_hash = bfc_hash_64(candidate_canon, m_mask, dede)
        boundary = False
        if mini_pos > k - m:
            # previous minimizer fell out of the window: full rescan
            boundary = True
            mini, mini_pos, reversed_, mini_hash = get_minimizer(
                kmer, k, m, dede)
        elif current_hash < mini_hash:
            boundary = True
            mini_hash = current_hash
            mini_pos = 0
            mini = candidate_canon
            reversed_ = candidate_canon == rc_mini_candidate
        if not reversed_:
            rec = KmerRecord(kmer, mini, mini_pos)
        else:
            rec = KmerRecord(rc_kmer, mini, k - m - mini_pos)
        yield rec, boundary and seq_idx > 0, reversed_


def enumerate_superkmers(seq: str, k: int, m: int, dede: DecyclingSet
                         ) -> Iterator[List[KmerRecord]]:
    """Yields super-k-mers exactly as the reference enumerator's caller
    observes them (each yield = one non-empty `next()` result), including
    the reversed-list emission order for minus-strand minimizers."""
    current: List[KmerRecord] = []
    cur_rev = False
    for rec, boundary, reversed_ in scan_emissions(seq, k, m, dede):
        if boundary and current:
            if cur_rev:
                current.reverse()
            yield current
            current = []
        current.append(rec)
        cur_rev = reversed_
    if current:
        if cur_rev:
            current.reverse()
        yield current


# ---------------------------------------------------------------------------
# Count oracle: the mode-2 verification map of the reference counter
# (counter.cpp:247-258): emitted kmer value -> count mod 256.
# ---------------------------------------------------------------------------

def count_sequence(counts: dict, seq: str, k: int, m: int,
                   dede: DecyclingSet) -> None:
    for skmer in enumerate_superkmers(seq, k, m, dede):
        for rec in skmer:
            counts[rec.kmer] = (counts.get(rec.kmer, 0) + 1) % 256


def clean_chunks(raw: str) -> List[str]:
    """Split a record's sequence at non-ACGT runs, uppercased — the
    observable effect of the reference's getLineFasta/clean_dna loop
    (counter.cpp:130-190)."""
    out = []
    cur = []
    for ch in raw:
        if ch in "ACGTacgt":
            cur.append(ch.upper())
        else:
            if cur:
                out.append("".join(cur))
                cur = []
    if cur:
        out.append("".join(cur))
    return out


def read_fasta_chunks(path: str) -> Iterator[str]:
    """Yields cleaned ACGT chunks from a (possibly multi-record) FASTA."""
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        seq_lines: List[str] = []
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if seq_lines:
                    yield from clean_chunks("".join(seq_lines))
                    seq_lines = []
            else:
                seq_lines.append(line)
        if seq_lines:
            yield from clean_chunks("".join(seq_lines))


def count_fasta(path: str, k: int, m: int) -> dict:
    dede = DecyclingSet(m)
    counts: dict = {}
    for chunk in read_fasta_chunks(path):
        if len(chunk) >= k:
            count_sequence(counts, chunk, k, m, dede)
    return counts


def str2kmer_record(s: str, m: int, dede: DecyclingSet) -> KmerRecord:
    """Scalar-get keying of a single k-mer string (reference str2kmer,
    Kmers.cpp:257-268): the FORWARD value with minimizer_idx mirrored when
    the minimizer is on the minus strand."""
    kv = str2num(s)
    k = len(s)
    mini, pos, rev, _ = get_minimizer(kv, k, m, dede)
    idx = pos if not rev else k - m - pos
    return KmerRecord(kv, mini, idx)


# ---------------------------------------------------------------------------
# Index-key oracle: hashed-minimizer k-mer key + bucket id
# (reference Brisk.hpp:107-111, 133-137; Kmers.cpp:191-200)
# ---------------------------------------------------------------------------

def hash_kmer_minimizer(kmer: int, minimizer_idx: int, m: int,
                        dede: DecyclingSet) -> int:
    """Replace the minimizer slice inside the k-mer by its hash
    (reference hash_kmer_minimizer_inplace, Kmers.cpp:191-200). The slice
    written back is the low 2m bits of the 64-bit hash (heavy bits 62-63
    fall outside for m <= 31... they are masked by replace_slice)."""
    m_mask = (1 << (2 * m)) - 1
    mini = (kmer >> (2 * minimizer_idx)) & m_mask
    hashed = bfc_hash_64(mini, m_mask, dede)
    # replace_slice masks the replacement to 2m bits (Kmers.cpp:149-159)
    hashed_slice = hashed & m_mask
    hole = ~(m_mask << (2 * minimizer_idx))
    return (kmer & hole) + (hashed_slice << (2 * minimizer_idx))


def bucket_id(hashed_minimizer: int, params) -> int:
    """Reduced minimizer = hashed minimizer with (m_reduc+1)/2 low bases
    dropped, masked to 2b bits (reference Brisk.hpp:135-137)."""
    small = hashed_minimizer >> (2 * params.suffix_reduc)
    return small & ((1 << (2 * params.b)) - 1)
