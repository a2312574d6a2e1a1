"""k-mers as 32-bit limbs, canonical k-mer counts and multi-word sorts in
plain PyTorch (int64 tensors), for the reference and the comparison.

A k-mer of the codes c[s .. s+k-1] (fasta.py's encoding) is the 2k-bit
value sum c[s+j] << 2(k-1-j), the first base most significant, as the
Brisk counter packs it. It is held as L = ceil(k / 16) limbs of 32 bits
(limb t = bits [32t, 32t+32), each in an int64 tensor), so no arithmetic
ever reaches the sign bit. The canonical form of a k-mer is the smaller
of it and its reverse complement.
"""

import torch

M32 = 0xFFFFFFFF


def n_limbs(k: int) -> int:
    return -(-k // 16)


def blocks16(codes: torch.Tensor) -> tuple:
    """(fwd, rc) int64 of the shape of `codes` (int64 in 0..3, along the
    last dim, zero-padded past its end): fwd[..., p] = the 16 bases from
    p, rc[..., p] = their reverse complement, each as a 32-bit value."""
    n = codes.shape[-1]
    c = torch.cat([codes, codes.new_zeros(codes.shape[:-1] + (16,))], -1)
    fwd = torch.zeros_like(codes)
    rc = torch.zeros_like(codes)
    for j in range(16):
        fwd = (fwd << 2) | c[..., j:j + n]
        rc = rc | ((c[..., j:j + n] ^ 2) << (2 * j))
    return fwd, rc


def kmer_limbs(fwd16: torch.Tensor, rc16: torch.Tensor, starts: torch.Tensor,
               k: int) -> tuple:
    """(fwd limbs, rc limbs) of the k-mers at `starts` (indices along the
    last dim of blocks16's blocks, which must reach start + k - 1), low
    limb first."""
    f, r = [], []
    for t in range(n_limbs(k)):
        nb = min(16, k - 16 * t)
        if nb == 16:
            f.append(fwd16[..., starts + (k - 16 * (t + 1))])
            r.append(rc16[..., starts + 16 * t])
        else:
            f.append(fwd16[..., starts] >> (2 * (16 - nb)))
            r.append(rc16[..., starts + 16 * t] & ((1 << (2 * nb)) - 1))
    return tuple(f), tuple(r)


def _rev_table(device) -> torch.Tensor:
    """The 4 bases of each byte value in reverse order."""
    t = [0] * 256
    for x in range(256):
        for j in range(4):
            t[x] |= ((x >> (2 * j)) & 3) << (2 * (3 - j))
    return torch.tensor(t, dtype=torch.int64, device=device)


def revcomp_limbs(limbs: tuple, k: int) -> tuple:
    """Reverse complements of k-mer values given as limbs."""
    n = len(limbs)
    rev4 = _rev_table(limbs[0].device)
    rev = []
    for t in reversed(range(n)):  # the top limb becomes the lowest
        x = limbs[t] ^ 0xAAAAAAAA  # complement: c ^ 2 per base
        r = torch.zeros_like(x)
        for j in range(4):
            r = r | (rev4[(x >> (8 * j)) & 0xFF] << (8 * (3 - j)))
        rev.append(r)
    pad = 32 * n - 2 * k
    if not pad:
        return tuple(rev)
    out = []
    for t in range(n):
        hi = rev[t + 1] if t + 1 < n else torch.zeros_like(rev[t])
        out.append(((rev[t] >> pad) | (hi << (32 - pad))) & M32)
    return tuple(out)


def less(a: tuple, b: tuple) -> torch.Tensor:
    """Elementwise a < b for limb tuples (low limb first)."""
    out = torch.zeros_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):  # later (higher) limbs decide over earlier
        out = torch.where(x != y, x < y, out)
    return out


def select(mask: torch.Tensor, a: tuple, b: tuple) -> tuple:
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def canonical(f: tuple, r: tuple) -> tuple:
    return select(less(r, f), r, f)


def pack_words(fields: list) -> list:
    """[(int64 tensor, bit width)] from most to least significant ->
    the fewest int64 words of at most 62 bits whose lexicographic order
    is the fields' (each field stays whole in one word)."""
    words, cur, used = [], None, 0
    for x, bits in fields:
        if cur is not None and used + bits <= 62:
            cur = (cur << bits) | x
            used += bits
        else:
            if cur is not None:
                words.append(cur)
            cur, used = x, bits
    words.append(cur)
    return words


def limb_fields(limbs: tuple, k: int) -> list:
    """A k-mer's limbs as pack_words fields, most significant first."""
    out = []
    for t in reversed(range(len(limbs))):
        out.append((limbs[t], 2 * min(16, k - 16 * t)))
    return out


def lexsort(words: list) -> torch.Tensor:
    """The permutation that sorts columns by words[0], then words[1], ...
    (stable least-significant-first passes)."""
    perm = torch.argsort(words[-1], stable=True)
    for w in reversed(words[:-1]):
        perm = perm[torch.argsort(w[perm], stable=True)]
    return perm


def run_starts(sorted_words: list) -> torch.Tensor:
    """Bool: the column starts a run of equal keys."""
    n = sorted_words[0].shape[0]
    first = torch.zeros(n, dtype=torch.bool, device=sorted_words[0].device)
    if n:
        first[0] = True
    for w in sorted_words:
        first[1:] |= w[1:] != w[:-1]
    return first


def valid_starts(codes_u8: torch.Tensor, k: int) -> torch.Tensor:
    """Positions s whose k bases c[s .. s+k-1] hold no break code."""
    brk = torch.cat([torch.zeros(1, dtype=torch.int64,
                                 device=codes_u8.device),
                     torch.cumsum((codes_u8 >= 4).to(torch.int64), 0)])
    n = codes_u8.shape[0] - k + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64, device=codes_u8.device)
    return torch.nonzero(brk[k:k + n] == brk[:n]).flatten()


def canonical_words(codes_u8: torch.Tensor, k: int,
                    chunk: int = 1 << 25) -> list:
    """The canonical form of every k-mer of a code array (break codes
    split), as pack_words words, in chunks of `chunk` positions."""
    starts = valid_starts(codes_u8, k)
    parts = []
    for a in range(0, codes_u8.shape[0], chunk):
        b = min(codes_u8.shape[0], a + chunk + k - 1)
        seg = codes_u8[a:b].to(torch.int64)
        fwd16, rc16 = blocks16(torch.where(seg < 4, seg, 0))
        del seg
        lo, hi = torch.searchsorted(starts, torch.tensor(
            [a, min(a + chunk, codes_u8.shape[0])], device=starts.device))
        s = starts[lo:hi] - a
        f, r = kmer_limbs(fwd16, rc16, s, k)
        del fwd16, rc16
        parts.append(pack_words(limb_fields(canonical(f, r), k)))
    return [torch.cat([p[i] for p in parts]) for i in range(len(parts[0]))]


def count_canonical(codes_u8: torch.Tensor, k: int) -> tuple:
    """(distinct canonical k-mers as sorted words, their counts int64,
    total k-mers)."""
    return count_words(canonical_words(codes_u8, k))


def count_words(words: list) -> tuple:
    """(distinct keys as sorted words, their counts int64, total keys)."""
    total = words[0].shape[0]
    perm = lexsort(words)
    words = [w[perm] for w in words]
    del perm
    first = run_starts(words)
    idx = torch.nonzero(first).flatten()
    counts = torch.diff(torch.cat([idx, idx.new_tensor([total])]))
    return [w[idx] for w in words], counts, total
