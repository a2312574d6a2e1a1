"""Decycling-set classification (reference Decycling.cpp:7-52).

R(seq) = sum over the m-mer's base slots of coef[4*i + v] in float64,
compared against eps = 1e-6, classifies each m-mer into {0: decycling
set, 1: double set, 2: other}; the class becomes the top two bits of the
minimizer hash. Both the CPU and the GPU have native float64, so R is
evaluated exactly as the C++ does (the same additions in the same order,
from the m-mer's last base upward), replacing the JAX package's
double-float emulation; classes equal pyref.DecyclingSet.mem_double.
"""

import functools

import torch

from brisk_tpu_torch.oracle import pyref


@functools.lru_cache(maxsize=None)
def _coef_rows(m: int):
    """(m, 4) float64 rows of the reference's coef table: row i holds
    coef[4*i + v] for v in 0..3 (row 0 is all zeros)."""
    coef = pyref.get_decycling(m).coef
    return [coef[4 * i: 4 * i + 4] for i in range(m)]


@functools.lru_cache(maxsize=None)
def coef_table(m: int, device) -> torch.Tensor:
    """The reference's (4m,) float64 coef table as one tensor on `device`
    (the rescan kernel's input: computed on the host, never with device
    sin/cos)."""
    return torch.tensor(pyref.get_decycling(m).coef, dtype=torch.float64,
                        device=device)


def _compute_r(seq: torch.Tensor, m: int) -> torch.Tensor:
    rows = _coef_rows(m)
    table = torch.tensor(rows, dtype=torch.float64, device=seq.device)
    r = torch.zeros(seq.shape, dtype=torch.float64, device=seq.device)
    s = seq
    for i in range(m - 1, 0, -1):
        r = r + table[i][s & 3]
        s = s >> 2
    return r


def mem_double(mmer_lo: torch.Tensor, mmer_hi: torch.Tensor, m: int
               ) -> torch.Tensor:
    """memDouble class (int64 in {0, 1, 2}) of 2-limb m-mers."""
    seq = mmer_lo | (mmer_hi << 32)  # 2m <= 62 bits: fits int64
    rot = ((seq & 3) << (2 * (m - 1))) + (seq >> 2)
    r = _compute_r(seq, m)
    r_rot = _compute_r(rot, m)
    eps = 1e-6
    cls = torch.full(seq.shape, 2, dtype=torch.int64, device=seq.device)
    cls = torch.where((r > eps) & (r_rot < eps), 0, cls)
    cls = torch.where((r < -eps) & (r_rot > -eps), 1, cls)
    return cls
