"""FASTA to 2-bit codes, plain numpy, for the reference.

Codes follow the Brisk counter: value = (ascii >> 1) & 3, so A=0, C=1,
T=2, G=3 and the complement is value ^ 2. Every other letter, and each
record's header, becomes the break code 4: a k-mer never spans one
(the counter splits its records at non-ACGT letters, counter.cpp:130-190).
"""

import numpy as np

BREAK = 4

_TABLE = np.full(256, BREAK, dtype=np.uint8)
for _c in b"ACGTacgt":
    _TABLE[_c] = (_c >> 1) & 3


def read_codes(path: str) -> np.ndarray:
    """All records of a FASTA file as one uint8 code array, each header
    line replaced by one break code, line ends dropped."""
    return read_codes_bytes(np.fromfile(path, dtype=np.uint8))


def read_codes_bytes(buf) -> np.ndarray:
    """read_codes of the file's bytes."""
    buf = np.frombuffer(buf, dtype=np.uint8)
    nl = buf == ord("\n")
    line_start = np.empty(buf.size, dtype=bool)
    line_start[0] = True
    line_start[1:] = nl[:-1]
    hdr_start = line_start & (buf == ord(">"))
    line_id = np.cumsum(line_start) - 1
    hdr_line = np.zeros(int(line_id[-1]) + 1, dtype=bool)
    hdr_line[line_id[hdr_start]] = True
    keep = ~nl & (~hdr_line[line_id] | hdr_start)
    return _TABLE[buf[keep]]


def chunks(codes: np.ndarray) -> tuple:
    """(starts, lengths) int64 of the maximal runs of bases between break
    codes."""
    ok = np.concatenate([[False], codes < BREAK, [False]])
    d = np.diff(ok.astype(np.int8))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    return starts.astype(np.int64), (ends - starts).astype(np.int64)


def n_kmers(codes: np.ndarray, k: int) -> int:
    """How many k-mers the counter enumerates: sum over chunks of
    max(0, length - k + 1)."""
    _, lens = chunks(codes)
    return int(np.maximum(lens - k + 1, 0).sum())
