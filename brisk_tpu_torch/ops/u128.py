"""Multi-limb unsigned integers as tuples of u32 limbs (little-endian).

Port of brisk_tpu.ops.u128. A limb is an int64 tensor holding a u32 value
(see brisk_tpu_torch._u32); k-mers use 4 limbs, m-mers and 64-bit hash
keys 2. Variable shifts of 32*n bits or more give 0, as in the reference's
select-over-limb-offsets form.
"""

from typing import Tuple

import torch

from brisk_tpu_torch._u32 import M32

Limbs = Tuple[torch.Tensor, ...]


def mask_bits(limbs: Limbs, nbits: int) -> Limbs:
    """Keep the low `nbits` bits (static)."""
    out = []
    for i, l in enumerate(limbs):
        lo = 32 * i
        if nbits <= lo:
            out.append(torch.zeros_like(l))
        elif nbits >= lo + 32:
            out.append(l)
        else:
            out.append(l & ((1 << (nbits - lo)) - 1))
    return tuple(out)


def shl(limbs: Limbs, s: int) -> Limbs:
    """Static left shift by s bits (truncated to the same limb count)."""
    n = len(limbs)
    words, bits = divmod(s, 32)
    out = []
    for i in range(n):
        v = torch.zeros_like(limbs[0])
        src = i - words
        if 0 <= src < n:
            v = (limbs[src] << bits) & M32 if bits else limbs[src]
        if bits and 0 <= src - 1 < n:
            v = v | (limbs[src - 1] >> (32 - bits))
        out.append(v)
    return tuple(out)


def shr(limbs: Limbs, s: int) -> Limbs:
    """Static logical right shift by s bits."""
    n = len(limbs)
    words, bits = divmod(s, 32)
    out = []
    for i in range(n):
        v = torch.zeros_like(limbs[0])
        src = i + words
        if 0 <= src < n:
            v = limbs[src] >> bits if bits else limbs[src]
        if bits and 0 <= src + 1 < n:
            v = v | ((limbs[src + 1] << (32 - bits)) & M32)
        out.append(v)
    return tuple(out)


def shl_var(limbs: Limbs, s: torch.Tensor) -> Limbs:
    """Variable left shift; s is a u32 tensor broadcastable to the limbs.
    A shift of 32*len(limbs) or more gives 0. In int64 a u32 shifted
    right by 32 is 0, so the bits == 0 carry needs no gate."""
    n = len(limbs)
    words = s >> 5
    bits = s & 31
    zero = torch.zeros_like(limbs[0])
    out = []
    for i in range(n):
        acc = zero
        for w in range(n):
            src = i - w
            if not 0 <= src < n:
                continue
            v = (limbs[src] << bits) & M32
            if src - 1 >= 0:
                v = v | (limbs[src - 1] >> (32 - bits))
            acc = torch.where(words == w, v, acc)
        out.append(acc)
    return tuple(out)


def shr_var(limbs: Limbs, s: torch.Tensor) -> Limbs:
    """Variable logical right shift (same contract as shl_var)."""
    n = len(limbs)
    words = s >> 5
    bits = s & 31
    zero = torch.zeros_like(limbs[0])
    out = []
    for i in range(n):
        acc = zero
        for w in range(n):
            src = i + w
            if not 0 <= src < n:
                continue
            v = limbs[src] >> bits
            if src + 1 < n:
                v = v | ((limbs[src + 1] << (32 - bits)) & M32)
            acc = torch.where(words == w, v, acc)
        out.append(acc)
    return tuple(out)


def bor(a: Limbs, b: Limbs) -> Limbs:
    return tuple(x | y for x, y in zip(a, b))


def band(a: Limbs, b: Limbs) -> Limbs:
    return tuple(x & y for x, y in zip(a, b))


def bnot(a: Limbs) -> Limbs:
    return tuple(x ^ M32 for x in a)


def bxor(a: Limbs, b: Limbs) -> Limbs:
    return tuple(x ^ y for x, y in zip(a, b))


def add(a: Limbs, b: Limbs) -> Limbs:
    """Multi-limb add (mod 2^(32n)); int64 limbs carry through bit 32."""
    out = []
    carry = None
    for x, y in zip(a, b):
        s = x + y if carry is None else x + y + carry
        carry = s >> 32
        out.append(s & M32)
    return tuple(out)


def eq(a: Limbs, b: Limbs) -> torch.Tensor:
    r = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        r = r & (x == y)
    return r


def lt(a: Limbs, b: Limbs) -> torch.Tensor:
    """Lexicographic a < b from the most significant limb down."""
    r = a[0] < b[0]
    for i in range(1, len(a)):
        r = torch.where(a[i] == b[i], r, a[i] < b[i])
    return r


def le(a: Limbs, b: Limbs) -> torch.Tensor:
    r = a[0] <= b[0]
    for i in range(1, len(a)):
        r = torch.where(a[i] == b[i], r, a[i] < b[i])
    return r


def select(pred: torch.Tensor, a: Limbs, b: Limbs) -> Limbs:
    return tuple(torch.where(pred, x, y) for x, y in zip(a, b))


def minimum(a: Limbs, b: Limbs) -> Limbs:
    return select(lt(a, b), a, b)


def stack(limbs: Limbs) -> torch.Tensor:
    return torch.stack(limbs, dim=0)


def unstack(arr: torch.Tensor) -> Limbs:
    return tuple(arr[i] for i in range(arr.shape[0]))
