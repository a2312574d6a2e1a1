"""brisk_tpu_torch's native FASTA parser, in byte ranges and from streams,
against the JAX package's Python reader and, where it builds, its native
parser."""
import gzip
import os
import threading

import numpy as np
import pytest

from brisk_tpu import native as ref_native
from brisk_tpu.io.fasta import chunk_codes
from brisk_tpu.oracle import pyref


def _pad(n: int, eol: str = "\n") -> str:
    """Exactly n bytes of sequence lines (at most 60 bases each), each
    ended by `eol`."""
    out = []
    while n > 0:
        line = min(60, n - len(eol))
        assert line > 0
        out.append("ACGTTGCA" * 8)
        out[-1] = out[-1][:line] + eol
        n -= line + len(eol)
    return "".join(out)


def _straddle(before: str, after: str, eol: str = "\n") -> str:
    """A file of two equal halves whose junction (the one nominal cut of
    two ranges, and one of eight) falls between `before` and `after`,
    `before` starting at a line start, sequence lines around them."""
    left = ">r" + eol + _pad(4000, eol) + before
    return left + after + _pad(len(left) - len(after), eol)


RANGE_CASES = {
    "cut_in_header": _straddle(">hea", "der line\nACGTAC\n"),
    "cut_before_header": _straddle("", ">next record\nGGCCA\n"),
    "crlf_cut_between_cr_lf": _straddle("ACGTAC\r", "\nTTGA\r\n",
                                        eol="\r\n"),
    "non_acgt_at_cut": _straddle("ACGN\n", "NNACGT\nRYACG\n"),
    "gt_mid_line": _straddle("AC>", "GT\nA>CGT\n"),
    "empty_records": _straddle(">e1\n>e2\n", ">e3\n\n>e4\n\nACGT\n>e5\n"),
    "no_trailing_newline": _straddle("ACGT\n", ">last\nAC") + "GTTA",
    "lowercase": _straddle("acgtn\n", "nacgt\n").lower(),
    "shorter_than_r_lines": ">x\nACGTNAC\nGG",
    "empty_file": "",
}
# more than a few of the parser's read blocks, so a stream's buffer grows
STREAM_TEXT = RANGE_CASES["empty_records"] * 300


def _same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)


def _check(got: list, path: str) -> None:
    """`got` equals the JAX package's Python reader on `path` and, where
    the toolchain builds, its native parser."""
    _same(got, [chunk_codes(c) for c in pyref.read_fasta_chunks(path)])
    if ref_native.load() is not None:
        _same(got, ref_native.parse_fasta_codes(path))


def _write(path: str, text: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "wt", newline="") as f:
            f.write(text)
    else:
        with open(path, "w", newline="") as f:
            f.write(text)
    return path


@pytest.fixture(scope="module")
def t_native():
    from brisk_tpu_torch import native as t
    if t.load() is None:
        pytest.skip("native toolchain unavailable")
    return t


@pytest.mark.parametrize("n_ranges", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("case", sorted(RANGE_CASES) + [
    "gzip", "data/test.fa", "data/debug_test.fa"])
def test_ranged_parse_parity(t_native, tmp_path, case, n_ranges):
    """The parse in n_ranges byte ranges equals the reference parsers and
    the one-range parse, chunk for chunk; a gzip file is one range."""
    if case.startswith("data/"):
        path = case
    elif case == "gzip":
        path = _write(str(tmp_path / "z.fa.gz"),
                      RANGE_CASES["cut_in_header"] + ">y\nTTTTNAC\n")
    else:
        path = _write(str(tmp_path / f"{case}.fa"), RANGE_CASES[case])
    got, used = t_native._parse(path, n_ranges)
    one, _ = t_native._parse(path, 1)
    _check(got, path)
    _same(got, one)
    assert t_native.parse_fasta_codes(path) is not None
    if case == "gzip":
        assert used == 1
    elif case in ("cut_in_header", "cut_before_header", "non_acgt_at_cut"):
        assert used == n_ranges  # every cut found a line start


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_stream_parse_parity(t_native, tmp_path, gz):
    """A FIFO, whose size reads 0, parses in one range from the handle
    already open, gzip included, and equals the reference parsers on a
    regular file of the same bytes."""
    name = "s.fa.gz" if gz else "s.fa"
    path = _write(str(tmp_path / name), STREAM_TEXT)
    fifo = str(tmp_path / "fifo")
    os.mkfifo(fifo)

    def feed() -> None:
        with open(path, "rb") as src, open(fifo, "wb") as dst:
            while block := src.read(1 << 16):
                dst.write(block)

    writer = threading.Thread(target=feed)
    writer.start()
    try:
        got, used = t_native._parse(fifo)
    finally:
        writer.join()
    assert used == 1
    assert sum(len(c) for c in got) > t_native.BLOCK
    _check(got, path)
