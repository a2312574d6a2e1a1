"""Vectorized invertible minimizer hash (reference hashing.cpp:8-49), port
of brisk_tpu.ops.hashing.

bfc_hash_64 is a Thomas-Wang style mixer masked to 2m bits with the
decycling class planted in bits 62-63. The 64-bit key lives in two u32
limbs; for m <= 16 the whole mix fits one limb because every masked step
satisfies (x mod 2^64) & mask == (x mod 2^32) & mask when mask < 2^32.
Hash totals order as (heavy, hi, lo) lexicographic triples.
"""

from typing import Tuple

import torch

from brisk_tpu_torch._u32 import M32
from brisk_tpu_torch.ops import decycling, u128

HashTriple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _mix64(lo: torch.Tensor, hi: torch.Tensor, m: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (lo, hi)

    def mask(v):
        return u128.mask_bits(v, 2 * m)

    key = mask(u128.add(u128.bnot(key), u128.shl(key, 21)))
    key = u128.bxor(key, u128.shr(key, 24))
    key = mask(u128.add(u128.add(key, u128.shl(key, 3)), u128.shl(key, 8)))
    key = u128.bxor(key, u128.shr(key, 14))
    key = mask(u128.add(u128.add(key, u128.shl(key, 2)), u128.shl(key, 4)))
    key = u128.bxor(key, u128.shr(key, 28))
    key = mask(u128.add(key, u128.shl(key, 31)))
    return key


def _mix32(lo: torch.Tensor, m: int) -> torch.Tensor:
    """Single-limb path for m <= 16: every step is masked to 2m <= 32
    bits, so int64 intermediates need no wrap beyond the mask."""
    mask = (1 << (2 * m)) - 1 if m < 16 else M32
    key = lo
    key = ((key ^ M32) + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def mix_key(mmer_lo: torch.Tensor, mmer_hi: torch.Tensor, m: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 2m-bit mixed key only (no decycling class). Returns (hi, lo)."""
    if m <= 16:
        lo = _mix32(mmer_lo, m)
        return torch.zeros_like(lo), lo
    lo, hi = _mix64(mmer_lo, mmer_hi, m)
    return hi, lo


def bfc_hash(mmer_lo: torch.Tensor, mmer_hi: torch.Tensor, m: int
             ) -> HashTriple:
    """(heavy, hi, lo): decycling class + 2m-bit mixed key."""
    heavy = decycling.mem_double(mmer_lo, mmer_hi, m)
    hi, lo = mix_key(mmer_lo, mmer_hi, m)
    return heavy, hi, lo


def hash_lt(a: HashTriple, b: HashTriple) -> torch.Tensor:
    return torch.where(
        a[0] != b[0], a[0] < b[0],
        torch.where(a[1] != b[1], a[1] < b[1], a[2] < b[2]))


def hash_eq(a: HashTriple, b: HashTriple) -> torch.Tensor:
    return (a[0] == b[0]) & (a[1] == b[1]) & (a[2] == b[2])


def pack_hash(heavy: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor
              ) -> torch.Tensor:
    """(heavy << 62) + key as ONE int64 that orders like the reference's
    uint64 hash: (heavy - 2) * 2^62 + key (heavy <= 2, key < 2^62)."""
    return (heavy - 2) * (1 << 62) + ((hi << 32) | lo)


def unpack_hash(h: torch.Tensor) -> HashTriple:
    """Inverse of pack_hash -> (heavy, hi, lo)."""
    key = h & ((1 << 62) - 1)
    return (h >> 62) + 2, key >> 32, key & M32
