"""Host-side FASTA streaming and lane packing (a copy of brisk_tpu.io.fasta;
numpy only).

Turns cleaned ACGT chunks (reference clean_dna/getLineFasta semantics,
counter.cpp:130-190 — implemented in oracle.pyref.read_fasta_chunks) into
fixed-shape (B, L_buf) 2-bit code buffers for the batched enumerator, with
per-lane fresh/valid_end metadata and k-1-base margins carrying records
across batches. All host work is numpy-vectorized (2-vCPU host).
"""

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from brisk_tpu_torch.oracle import pyref


def chunk_codes(chunk: str) -> np.ndarray:
    """ACGT string -> uint8 2-bit codes ((c>>1)&3, Kmers.cpp:442-444)."""
    raw = np.frombuffer(chunk.encode(), dtype=np.uint8)
    return (raw >> 1) & 3


@dataclass
class Batch:
    codes: np.ndarray      # (B, L_buf) uint8
    fresh: np.ndarray      # (B,) bool
    valid_end: np.ndarray  # (B,) int32: one past the last valid base index
    n_kmers: int           # total valid emissions in this batch


@dataclass
class _Lane:
    rest: Optional[np.ndarray] = None  # remaining codes of active record
    tail: Optional[np.ndarray] = None  # last k-1 codes already processed


class BatchPacker:
    """Packs a stream of record chunks into enumerator batches.

    Records shorter than k are dropped (reference count_sequence,
    counter.cpp:233). Records longer than l_new continue across batches in
    the same lane with a k-1 margin, matching the streaming-carry contract
    of ops.enumerate.enumerate_batch.
    """

    def __init__(self, k: int, batch: int, l_new: int):
        assert l_new >= 1
        self.k = k
        self.margin = k - 1
        self.batch = batch
        self.l_buf = self.margin + l_new
        self.l_new = l_new

    def pack(self, chunks: Iterator[str]) -> Iterator[Batch]:
        k, margin, l_buf, l_new = self.k, self.margin, self.l_buf, self.l_new
        lanes: List[_Lane] = [_Lane() for _ in range(self.batch)]
        chunks = iter(chunks)
        exhausted = False
        while True:
            codes = np.zeros((self.batch, l_buf), dtype=np.uint8)
            fresh = np.zeros(self.batch, dtype=bool)
            valid_end = np.zeros(self.batch, dtype=np.int32)
            n_kmers = 0
            any_data = False
            for i, lane in enumerate(lanes):
                if lane.rest is None and not exhausted:
                    # pull the next schedulable record (ACGT string or a
                    # pre-encoded uint8 code array from the native parser)
                    while True:
                        try:
                            c = next(chunks)
                        except StopIteration:
                            exhausted = True
                            break
                        if len(c) >= k:
                            lane.rest = (chunk_codes(c)
                                         if isinstance(c, str) else c)
                            lane.tail = None
                            break
                if lane.rest is None:
                    fresh[i] = True
                    continue
                any_data = True
                if lane.tail is None:
                    # fresh record: bases from index 0
                    fresh[i] = True
                    n = min(len(lane.rest), l_buf)
                    codes[i, :n] = lane.rest[:n]
                    valid_end[i] = n
                    n_kmers += n - k + 1
                else:
                    # continuation: margin then new bases
                    codes[i, :margin] = lane.tail
                    n = min(len(lane.rest), l_new)
                    codes[i, margin:margin + n] = lane.rest[:n]
                    valid_end[i] = margin + n
                    n_kmers += n
                if valid_end[i] < l_buf:
                    lane.rest = None  # record finished
                    lane.tail = None
                else:
                    consumed = l_buf if lane.tail is None else n
                    lane.tail = codes[i, valid_end[i] - margin:valid_end[i]].copy()
                    lane.rest = lane.rest[consumed:]
                    if len(lane.rest) == 0:
                        lane.rest = None
                        lane.tail = None
            if not any_data:
                return
            yield Batch(codes, fresh, valid_end, n_kmers)


def fasta_batches(path: str, k: int, batch: int, l_new: int
                  ) -> Iterator[Batch]:
    """Batches from a FASTA file, preferring the native C++ parser (2-bit
    codes produced off the Python hot path) with a pure-Python fallback."""
    from brisk_tpu_torch import native

    packer = BatchPacker(k, batch, l_new)
    chunks = native.parse_fasta_codes(path)
    if chunks is not None:
        return packer.pack(iter(chunks))
    return packer.pack(pyref.read_fasta_chunks(path))
