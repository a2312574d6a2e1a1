"""u32 word helpers and the shared stable lexicographic multi-word sort.

torch has no arithmetic on uint32, so a u32 under arithmetic lives in an
int64 tensor with values in [0, 2^32); every operation that can leave that
range (add, left shift, multiply, not) is masked back with `M32`. int64
`>>` is arithmetic, which is harmless here because the values are never
negative. Stored columns are int32 tensors holding the u32 bit pattern
(`to_i32` / `to_u32` convert).
"""

import numpy as np
import torch

M32 = 0xFFFFFFFF
INVALID = M32  # the all-ones sentinel word (dead rows / dead slots)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any int tensor) -> int64 u32 value."""
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 value -> int32 tensor holding the same bit pattern."""
    return (((x & M32) + (1 << 31)) & M32).sub_(1 << 31).to(torch.int32)


def from_np(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 array -> int32 bit-pattern tensor on `device`."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_np(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern (or int64 u32) tensor -> numpy uint32 array."""
    t = t.detach().cpu()
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    return (t & M32).numpy().astype(np.uint32)


def lexsort(words, dim: int = -1) -> torch.Tensor:
    """Permutation (int64 indices along `dim`) that sorts the columns of
    `words` lexicographically, words[0] most significant — the port of
    `jax.lax.sort(..., num_keys=W)` (stable: equal keys keep their input
    order). W stable passes from the least significant word up, each a
    sort of the already-permuted word followed by a gather. int32 words
    are widened to u32 first, so values >= 2^31 do not sort as negatives.
    """
    perm = None
    for w in reversed(list(words)):
        key = w if w.dtype == torch.int64 else to_u32(w)
        if perm is not None:
            key = torch.gather(key, dim, perm)
        idx = torch.sort(key, dim=dim, stable=True).indices
        perm = idx if perm is None else torch.gather(perm, dim, idx)
    return perm
