"""Native (C++) FASTA parser, loaded via ctypes.

`fasta_codec.cpp` is built with g++ into `brisk_tpu_torch/_build/` at
first use, named by the source's content hash. If the build fails (no
compiler), `parse_fasta_codes` returns None and callers fall back to the
Python parser (`oracle.pyref.read_fasta_chunks`) — host code only,
slower.

The codes go into one buffer that the caller allocates, as many bytes as
the file has. An uncompressed regular file is cut at line starts into up
to MAX_RANGES ranges of at least MIN_RANGE bytes (no more than the usable
CPUs), each read with `pread` in BLOCK-byte blocks and parsed on a thread
of its own straight into the buffer at its own byte offset; the ranges'
codes are then moved down to one run and their splits become the chunk
offsets. A gzip file or a stream (a pipe, /dev/stdin) is one range, read
in order from the handle already open (decompressed by zlib where it is
gzip), its buffer grown as the codes come. Each range is a `parse.range`
span on a thread other than the caller's, under the caller's span path.
"""

import ctypes
import gzip
import hashlib
import io
import os
import stat
import subprocess
import threading
from typing import Optional

import numpy as np

from brisk_tpu_torch import spans

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fasta_codec.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
MAX_RANGES = 8
MIN_RANGE = 4 << 20
BLOCK = 1 << 20
_lib = None
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None if the build fails."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, f"libbrisk_native_{digest}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++"] + _FLAGS + [_SRC, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp, u64 = ctypes.c_void_p, ctypes.c_uint64
        lib.brisk_fasta_new.restype = vp
        lib.brisk_fasta_new.argtypes = []
        lib.brisk_fasta_free.restype = None
        lib.brisk_fasta_free.argtypes = [vp]
        lib.brisk_fasta_feed.restype = u64
        lib.brisk_fasta_feed.argtypes = [vp, vp, u64, vp]
        lib.brisk_fasta_n_splits.restype = u64
        lib.brisk_fasta_n_splits.argtypes = [vp]
        lib.brisk_fasta_splits.restype = ctypes.POINTER(u64)
        lib.brisk_fasta_splits.argtypes = [vp]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _load_failed = True
    return _lib


def _n_ranges(size: int) -> int:
    """Ranges for an uncompressed file of `size` bytes: the usable CPUs,
    at most MAX_RANGES, each at least MIN_RANGE bytes."""
    return max(1, min(len(os.sched_getaffinity(0)), MAX_RANGES,
                      size // MIN_RANGE))


def _cuts(fd: int, size: int, n: int) -> list:
    """[0, c_1, ..., size]: each c_i the first line start at or after
    i * size / n, or no cut when none comes before the next one's."""
    cuts = [0]
    for i in range(1, n):
        lo, hi = max(i * size // n, cuts[-1] + 1), (i + 1) * size // n
        pos = lo - 1  # a line start: the byte before it is '\n'
        while pos < hi:
            block = os.pread(fd, min(1 << 16, hi - pos), pos)
            if not block:
                break
            j = block.find(b"\n")
            if j >= 0:
                cuts.append(pos + j + 1)
                break
            pos += len(block)
    return cuts + [size]


def _splits(lib, h):
    n = lib.brisk_fasta_n_splits(h)
    if not n:
        return np.zeros(0, np.uint64)
    return np.ctypeslib.as_array(lib.brisk_fasta_splits(h), (n,)).copy()


class _Unread(io.RawIOBase):
    """`fh` with `head`, bytes already read from it, given back first."""

    def __init__(self, head: bytes, fh):
        super().__init__()
        self._head, self._fh = head, fh

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if not self._head:
            return self._fh.readinto(b)
        n = min(len(b), len(self._head))
        memoryview(b)[:n] = self._head[:n]
        self._head = self._head[n:]
        return n


def _pread(fd: int, begin: int, end: int):
    """readinto over bytes [begin, end) of `fd`."""
    pos = begin

    def readinto(block) -> int:
        nonlocal pos
        if pos >= end:
            return 0
        got = os.preadv(fd, [block[:end - pos]], pos)
        if not got:
            raise IOError("FASTA file ended before its parse did")
        pos += got
        return got
    return readinto


def _feed(lib, readinto, buf, at: int = 0):
    """(buf, codes, splits) of the bytes that readinto(block) gives until
    it gives none, parsed from a line start with the codes at buf[at..);
    buf is replaced by a larger copy where the codes might not fit."""
    block = np.empty(BLOCK, np.uint8)
    h = lib.brisk_fasta_new()
    try:
        n = 0
        while got := readinto(block):
            if at + n + got > buf.size:
                grown = np.empty(2 * buf.size + got, np.uint8)
                grown[:at + n] = buf[:at + n]
                buf = grown
            n = lib.brisk_fasta_feed(h, block.ctypes.data, got,
                                     buf.ctypes.data + at)
        return buf, n, _splits(lib, h)
    finally:
        lib.brisk_fasta_free(h)


def _parse_buffer(path: str, n_ranges: int = None):
    """(codes, offs, ranges parsed): every chunk's codes in one buffer,
    chunk i at codes[offs[i]:offs[i + 1]] (offs int64, no empty chunk);
    None if the native lib is unavailable. `n_ranges` forces the number
    of ranges of an uncompressed file."""
    lib = load()
    if lib is None:
        return None
    ctx = spans.context()
    with open(path, "rb") as fh:
        st = os.fstat(fh.fileno())
        head = fh.read(2)
        stream = None
        if head == b"\x1f\x8b" or not stat.S_ISREG(st.st_mode):
            stream = _Unread(head, fh)
            if head == b"\x1f\x8b":
                stream = gzip.GzipFile(fileobj=stream)
            ranges = [(0, None)]
            buf = np.empty(max(BLOCK, 4 * st.st_size), np.uint8)
        else:
            cuts = _cuts(fh.fileno(), st.st_size,
                         n_ranges or _n_ranges(st.st_size))
            ranges = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
            ranges = ranges or [(0, 0)]
            buf = np.empty(st.st_size, np.uint8)
        results = [None] * len(ranges)

        def work(i: int) -> None:
            spans.adopt(ctx)
            a, b = ranges[i]
            readinto = stream.readinto if stream else _pread(
                fh.fileno(), a, b)
            try:
                with spans.span("parse.range"):
                    results[i] = _feed(lib, readinto, buf, a)
            except Exception as e:  # raised again on the calling thread
                results[i] = e

        # one thread a range, also for one: a range's span is never a
        # child of the caller's parse span on its thread, which would
        # take the range's time out of the parse's own
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(ranges))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for r in results:
        if isinstance(r, Exception):
            raise r
    buf = results[0][0]  # a stream's buffer may have grown
    # each range's codes down to the end of the previous range's
    total, splits = 0, []
    for (a, _), (_, n, sp) in zip(ranges, results):
        if n and a != total:
            ctypes.memmove(buf.ctypes.data + total, buf.ctypes.data + a, n)
        splits.append(sp + np.uint64(total))
        total += n
    offs = np.concatenate([np.zeros(1, np.uint64), *splits,
                           np.full(1, total, np.uint64)])
    offs = offs[np.concatenate(([True], offs[1:] != offs[:-1]))]
    return buf[:total], offs.astype(np.int64), len(ranges)


def _parse(path: str, n_ranges: int = None):
    """(chunks, ranges parsed); None if the native lib is unavailable.
    `n_ranges` forces the number of ranges of an uncompressed file."""
    got = _parse_buffer(path, n_ranges)
    if got is None:
        return None
    codes, offs, n = got
    offs = offs.tolist()
    return [codes[a:b] for a, b in zip(offs, offs[1:])], n


def parse_fasta_buffer(path: str):
    """Parse a FASTA file natively: (codes, offs), every cleaned chunk's
    uint8 codes in one buffer, chunk i at codes[offs[i]:offs[i + 1]]; or
    None if the native lib is unavailable."""
    got = _parse_buffer(path)
    return None if got is None else got[:2]


def parse_fasta_codes(path: str):
    """Parse a FASTA file natively: a list of numpy uint8 code arrays
    (one per cleaned chunk, each a view into one buffer), or None if the
    native lib is unavailable."""
    got = _parse(path)
    return None if got is None else got[0]
