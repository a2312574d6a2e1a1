"""Reverse complement and canonicalization (port of
brisk_tpu.ops.revcomp), bit-exact with the reference:

* rcb64: the TRUE reverse complement of an n <= 32 base value;
* rcb128_broken: the reference's 128-bit variant whose byte swap result
  is discarded, so only the nucleotides inside each byte are reversed.
  It feeds only the canonized() strand test of get_minimizer's
  equal-distance tie-break. Replicated on purpose; do not "fix".
"""

from typing import Tuple

import torch

from brisk_tpu_torch._u32 import M32
from brisk_tpu_torch.ops import u128

_C1 = 0x0F0F0F0F
_C2 = 0x33333333
_COMP = 0xAAAAAAAA


def _swizzle_byte_local(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 4 nucleotides within every byte and complement."""
    x = ((x & _C1) << 4) | ((x & (_C1 << 4)) >> 4)
    x = ((x & _C2) << 2) | ((x & (_C2 << 2)) >> 2)
    return x ^ _COMP


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x << 24) & M32) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | (x >> 24))


def rcb64(lo: torch.Tensor, hi: torch.Tensor, n: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """True reverse complement of n <= 32 bases held in 2 limbs."""
    new_lo = _swizzle_byte_local(_bswap32(hi))
    new_hi = _swizzle_byte_local(_bswap32(lo))
    return u128.shr((new_lo, new_hi), 64 - 2 * n)


def canonize64(lo: torch.Tensor, hi: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min(x, rcb64(x)): the canonical m-mer."""
    return u128.minimum((lo, hi), rcb64(lo, hi, n))


def rcb128_broken(limbs: u128.Limbs, n: int) -> u128.Limbs:
    """Per-limb in-byte swizzle + complement (no byte or limb reversal),
    then realign right by 128-2n bits."""
    return u128.shr(tuple(_swizzle_byte_local(l) for l in limbs),
                    128 - 2 * n)


def canonized_k(kmer: u128.Limbs, k: int) -> torch.Tensor:
    """Strand test x <= broken_rc(x)."""
    return u128.le(kmer, rcb128_broken(kmer, k))
