"""2-bit DNA codec and vectorized window packing (port of
brisk_tpu.ops.codec).

Encoding: value = (ascii >> 1) & 3, so A=0, C=1, T=2, G=3 and the
complement is value ^ 2. Every k-mer / m-mer / reverse-complement value
at every position comes from doubling packs (16 bases per u32 word)
composed into limbs with static shifts. Arrays are (..., L) over base
positions; position p holds the window ENDING at p (last base in the low
bits). Positions p < window-1 hold garbage and are masked by callers.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from brisk_tpu_torch._u32 import M32
from brisk_tpu_torch.ops import u128


def _shift_right_axis(x: torch.Tensor, n: int) -> torch.Tensor:
    """x[..., p] -> x[..., p-n], zero-filling on the left."""
    if n == 0:
        return x
    return F.pad(x, (n, 0))[..., : x.shape[-1]]


def fwd_packs16(codes: torch.Tensor) -> torch.Tensor:
    """w16[..., p] = sum_{u=0..15} codes[..., p-u] << 2u."""
    w = codes
    for step in (1, 2, 4, 8):
        w = ((_shift_right_axis(w, step) << (2 * step)) & M32) | w
    return w


def rc_packs16(codes: torch.Tensor) -> torch.Tensor:
    """v16[..., p] = sum_{u=0..15} (codes[..., p-u]^2) << 2(15-u)."""
    v = codes ^ 2
    for step in (1, 2, 4, 8):
        v = ((v << (2 * step)) & M32) | _shift_right_axis(v, step)
    return v


def compose_fwd(w16: torch.Tensor, n: int, n_limbs: int) -> u128.Limbs:
    limbs = tuple(_shift_right_axis(w16, 16 * j) for j in range(n_limbs))
    return u128.mask_bits(limbs, 2 * n)


def compose_rc(v16: torch.Tensor, n: int, n_limbs: int) -> u128.Limbs:
    limbs = [torch.zeros_like(v16)] * n_limbs
    for t in range((n + 15) // 16):
        word = _shift_right_axis(v16, 16 * t)
        limbs = _deposit(limbs, word, 2 * n - 32 - 32 * t)
    return u128.mask_bits(tuple(limbs), 2 * n)


def _deposit(limbs, word: torch.Tensor, bitpos: int) -> list:
    """OR (word << bitpos) into u32 limbs; bitpos may be negative."""
    n = len(limbs)
    out = list(limbs)
    if bitpos >= 0:
        w, b = divmod(bitpos, 32)
        if w < n:
            out[w] = out[w] | (((word << b) & M32) if b else word)
        if b and w + 1 < n:
            out[w + 1] = out[w + 1] | (word >> (32 - b))
    else:
        out[0] = out[0] | (word >> -bitpos)
    return out


def kmer_windows(codes: torch.Tensor, k: int, m: int
                 ) -> Tuple[u128.Limbs, u128.Limbs, u128.Limbs, u128.Limbs]:
    """(fwd_kmer[4], rc_kmer[4], fwd_mmer[2], rc_mmer[2]) limbs at every
    position of int64 `codes`."""
    w16 = fwd_packs16(codes)
    v16 = rc_packs16(codes)
    return (compose_fwd(w16, k, 4), compose_rc(v16, k, 4),
            compose_fwd(w16, m, 2), compose_rc(v16, m, 2))
