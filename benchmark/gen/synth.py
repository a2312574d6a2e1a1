"""Seeded synthetic genomes and read sets, written as FASTA.

Frozen from brisk_tpu_torch/io/synth.py (commit 44e47b2): uniform random
bases with sparse N's (one draw per 10,000 bases), one record of
80-column lines. Extended with the read samplers the cells need: reads
of a fixed multiset of lengths drawn from a genome at seeded starts, from
both strands, with an exact number of substitutions.

Every function takes a numpy Generator; the same seed gives the same
bytes. Sizes never depend on the seed: a genome has its stated length,
a read set its stated read lengths (only their order and starts vary),
so every seed asks the program for the same amount of work.

Bases are held as uint8 codes 0-3 for A, C, G, T and 4 for N.
"""

import numpy as np

LETTERS = np.frombuffer(b"ACGTN", dtype=np.uint8)
N_CODE = 4


def streams(seed: int, n: int) -> list:
    """n independent Generators derived from `seed` (any non-negative
    int, also past 32 bits)."""
    ss = np.random.SeedSequence(int(seed))
    return [np.random.default_rng(s) for s in ss.spawn(n)]


def genome(rng: np.random.Generator, n_bases: int,
           n_per: int = 10000) -> np.ndarray:
    """n_bases uniform random codes with N's at n_bases // n_per seeded
    positions (io/synth.py's density)."""
    codes = rng.integers(0, 4, size=n_bases, dtype=np.uint8)
    codes[rng.integers(0, n_bases, size=max(1, n_bases // n_per))] = N_CODE
    return codes


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis (N stays N)."""
    out = np.where(codes < 4, 3 - codes.astype(np.int16), codes)
    return out[..., ::-1].astype(np.uint8)


def substitute(rng: np.random.Generator, flat: np.ndarray,
               rate: float) -> None:
    """In place: round(rate * len) seeded positions of the flat code
    array take another base (an N position stays N)."""
    n_sub = int(round(rate * flat.size))
    if not n_sub:
        return
    pos = rng.integers(0, flat.size, size=n_sub)
    shift = rng.integers(1, 4, size=n_sub, dtype=np.uint8)
    old = flat[pos]
    flat[pos] = np.where(old < 4, (old + shift) % 4, old)


def sample_reads(rng: np.random.Generator, source: np.ndarray,
                 lengths: np.ndarray, sub_rate: float) -> list:
    """One read per entry of `lengths` (in a seeded order), each from a
    uniform start in `source`, reverse complemented with probability 1/2,
    with round(sub_rate * bases) substitutions over the whole set."""
    lengths = rng.permutation(np.asarray(lengths, dtype=np.int64))
    starts = rng.integers(0, source.size - lengths + 1)
    minus = rng.random(lengths.size) < 0.5
    flat = np.empty(int(lengths.sum()), dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    if np.all(lengths == lengths[0]):
        L = int(lengths[0])
        reads = source[starts[:, None] + np.arange(L)]
        reads[minus] = revcomp(reads[minus])
        flat[:] = reads.reshape(-1)
    else:
        for i, (s, L) in enumerate(zip(starts, lengths)):
            r = source[s:s + L]
            flat[offs[i]:offs[i + 1]] = revcomp(r) if minus[i] else r
    substitute(rng, flat, sub_rate)
    return [flat[offs[i]:offs[i + 1]] for i in range(lengths.size)]


def hifi_lengths(total_bases: int, lo: int, hi: int) -> np.ndarray:
    """Read lengths spread evenly over [lo, hi] whose sum is as close to
    `total_bases` as whole reads allow (the same for every seed)."""
    n = max(1, int(round(total_bases / ((lo + hi) / 2))))
    return np.linspace(lo, hi, n).round().astype(np.int64)


def write_contig(path: str, codes: np.ndarray, name: str = "synth",
                 width: int = 80) -> None:
    """One record of `width`-column lines."""
    n = codes.size
    rows = -(-n // width)
    buf = np.full((rows, width + 1), ord("\n"), dtype=np.uint8)
    pad = np.full(rows * width, N_CODE, dtype=np.uint8)
    pad[:n] = codes
    buf[:, :width] = LETTERS[pad].reshape(rows, width)
    body = buf.reshape(-1)
    last = n - (rows - 1) * width  # letters in the final line
    body = body[:(rows - 1) * (width + 1) + last]
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(body.tobytes())
        f.write(b"\n")


def write_reads(path: str, reads: list, prefix: str = "r") -> None:
    """One record per read, each sequence on one line."""
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(f">{prefix}{i}\n".encode())
            f.write(LETTERS[r].tobytes())
            f.write(b"\n")
