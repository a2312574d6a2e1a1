"""Deterministic synthetic FASTA inputs for the bench, the traces and the
smoke run: uniform random bases from a seed, with sparse N's (~0.01%) so
that the parsers split chunks. The same (n_bases, read_len, seed) gives
the same bytes as tests/make_synth_fasta.write_synth.

    python -m brisk_tpu_torch.io.synth <out.fa> <n_bases> [--reads L] [--seed S]
"""

import argparse

import numpy as np


def write_synth(out: str, n_bases: int, read_len: int = 0,
                seed: int = 1234) -> None:
    """Write n_bases random bases to `out`: records of read_len bases
    (`>r{i}` headers), or one contig of 80-column lines when read_len is
    0."""
    n = n_bases
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    seq = np.frombuffer(b"ACTG", dtype=np.uint8)[codes]
    pos = rng.integers(0, n, size=max(1, n // 10000))
    seq[pos] = ord("N")
    seq = seq.tobytes().decode()
    with open(out, "w") as f:
        if read_len:
            for i, j in enumerate(range(0, n, read_len)):
                f.write(f">r{i}\n{seq[j:j + read_len]}\n")
        else:
            f.write(">synth\n")
            for j in range(0, n, 80):
                f.write(seq[j:j + 80] + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("n_bases", type=int)
    ap.add_argument("--reads", type=int, default=0)
    ap.add_argument("--seed", type=int, default=1234)
    a = ap.parse_args(argv)
    write_synth(a.out, a.n_bases, a.reads, a.seed)


if __name__ == "__main__":
    main()
