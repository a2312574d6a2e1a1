"""Sorted slots for the run-scan tests (tests/test_torch_run_scan.py on
the CPU, tests/test_torch_cuda.py on the card): numpy-seeded runs of
keys in the layouts that csrc/run_scan.cu's two kernels take. Imports
numpy and torch only."""

import numpy as np
import torch

M32 = 0xFFFFFFFF


def sorted_runs(rng, n: int, W: int, max_run: int):
    """n sorted slots in runs of 1..max_run slots: (W, n) int64 u32 words,
    each run's key distinct, the side tag in bit 0 of the last word (index
    slots of a key, tag 0, before its query slots, tag 1); and the (n,)
    bool tags."""
    lens = rng.integers(1, max_run + 1, n)
    ends = np.cumsum(lens)
    n_runs = int(np.searchsorted(ends, n)) + 1
    lens = lens[:n_runs]
    lens[-1] -= ends[n_runs - 1] - n
    run = np.repeat(np.arange(n_runs), lens)
    pos = np.arange(n) - (np.cumsum(lens) - lens)[run]
    n_index = (rng.random(n_runs) * (lens + 1)).astype(np.int64)
    tags = (pos >= n_index[run]).astype(np.int64)
    keys = np.cumsum(rng.integers(1, 64, n_runs))  # distinct, increasing
    words = np.zeros((W, n), np.int64)
    words[W - 2 if W > 1 else 0] = keys[run]
    words[W - 1] = ((words[W - 1] << 1) & M32) | tags
    return torch.from_numpy(words), torch.from_numpy(tags.astype(bool))


def join_inputs(n: int, W: int, max_run: int, seed: int):
    """The join scan's inputs: sorted words (W, n) and payloads (n,) int64,
    index counts anywhere in [0, 2^32) (half of them below 300, so that
    runs mix small counts with sums past 2^32) and query liveness 0, 1 or
    2 (2 reads nothing)."""
    rng = np.random.default_rng(seed)
    words, is_q = sorted_runs(rng, n, W, max_run)
    pay = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.int64))
    small = torch.from_numpy(rng.random(n) < 0.5)
    pay = torch.where(small, pay % 300, pay)
    return words, torch.where(is_q, pay % 3, pay)


def run_inputs(n: int, max_run: int, seed: int):
    """compact's run-scan inputs: data (n,) int64 counts in [0, 2^32), 30%
    of them 0, and the (n,) bool run starts of sorted runs of 1..max_run
    slots (the first slot always starts one)."""
    rng = np.random.default_rng(seed)
    words, _ = sorted_runs(rng, n, 1, max_run)
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = words[0, 1:] != words[0, :-1]
    data = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.int64))
    data[torch.from_numpy(rng.random(n) < 0.3)] = 0
    return data, first
