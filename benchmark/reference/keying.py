"""The Brisk counter's key of every k-mer emission of a set of short
reads, in plain PyTorch.

The counter stores each k-mer under its emitted orientation and the
position of its minimizer (the reference SuperKmerEnumerator,
Kmers.cpp:509-613, with its quirks: get_minimizer's equal-hash
tie-breaks and, for k > 32, its scan of the k-mer's low 64 bits only,
Kmers.cpp:367-408). So a k-mer seen from both strands, or in different
contexts, can lie under two keys, and a query k-mer adds the count
stored under its own key. This module replays that enumerator on every
chunk at once (one lane per piece of a chunk, the lanes in lock-step
over positions); it is written from the reference's description and the
frozen copy of the port's oracle (pyref_frozen.py), and imports nothing
of the program.

A chunk longer than one piece (a chromosome, a long read) is cut into
pieces. The enumerator's next state depends only on its state and the
next bases, so a piece that starts `overlap` k-mers early from a fresh
state agrees with the chunk's own scan from the first position where
its state equals the previous piece's; that position has to lie in the
overlap, and the piece keeps its emissions from the overlap's end on.
A piece whose state never meets the previous one's raises: the keys are
exact or there are none.

emission_keys(codes, k, m) -> (limbs of the emitted k-mer, mini_idx) per
emission: the key the program stores a k-mer under, and its query join
looks up.
"""

import math

import numpy as np
import torch

from benchmark.reference import fasta, kmers

_EPS = 0.000001


def _coef(m: int) -> list:
    """The decycling set's table (Decycling.cpp:7-52): coef[t][v] =
    v * sin(2 pi t / m) for t in 1..m-1, as the counter computes it."""
    unit = 2 * math.pi / m
    out = [[0.0] * 4 for _ in range(m)]
    for t in range(1, m):
        s = math.sin(unit * t)
        out[t] = [0.0, s, 2 * s, 3 * s]
    return out


class MmerMath:
    """Per-m tables and the m-mer functions, on one device."""

    def __init__(self, m: int, device):
        self.m = m
        self.mask = (1 << (2 * m)) - 1
        self.coef = torch.tensor(_coef(m), dtype=torch.float64,
                                 device=device)
        rc4 = [0] * 256  # reverse complement of 4 bases
        for x in range(256):
            v = 0
            for j in range(4):
                v = (v << 2) | (((x >> (2 * j)) & 3) ^ 2)
            rc4[x] = v
        self.rc4 = torch.tensor(rc4, dtype=torch.int64, device=device)

    def revcomp(self, x: torch.Tensor) -> torch.Tensor:
        """True reverse complement of m-base values."""
        nbytes = -(-self.m // 4)
        out = torch.zeros_like(x)
        for j in range(nbytes):
            out = (out << 8) | self.rc4[(x >> (8 * j)) & 0xFF]
        return out >> (2 * (4 * nbytes - self.m))

    def _r(self, seq: torch.Tensor) -> torch.Tensor:
        """compute_r: the decycling sum, added in the counter's order."""
        r = torch.zeros(seq.shape, dtype=torch.float64, device=seq.device)
        for j in range(self.m - 1):
            r = r + self.coef[self.m - 1 - j][(seq >> (2 * j)) & 3]
        return r

    def heavy(self, seq: torch.Tensor) -> torch.Tensor:
        """mem_double: 0 decycling set, 1 double set, 2 other."""
        r = self._r(seq)
        rot = ((seq & 3) << (2 * (self.m - 1))) + (seq >> 2)
        r2 = self._r(rot)
        out = torch.full_like(seq, 2)
        out = torch.where((r > _EPS) & (r2 < _EPS), 0, out)
        return torch.where((r < -_EPS) & (r2 > -_EPS), 1, out)

    def mix(self, key: torch.Tensor) -> torch.Tensor:
        """bfc_hash_64's mixing (hashing.cpp:8-20) on 2m-bit values."""
        mask = self.mask
        key = (~key + (key << 21)) & mask
        key = key ^ (key >> 24)
        key = ((key + (key << 3)) + (key << 8)) & mask
        key = key ^ (key >> 14)
        key = ((key + (key << 2)) + (key << 4)) & mask
        key = key ^ (key >> 28)
        return (key + ((key & (mask >> 31)) << 31)) & mask

    def props(self, fwd: torch.Tensor) -> tuple:
        """(canonical m-mer, its hash as one ordered int64: heavy class
        above the 2m mixed bits) of forward m-mer values."""
        canon = torch.minimum(fwd, self.revcomp(fwd))
        return canon, (self.heavy(canon) << (2 * self.m)) | self.mix(canon)


def _half(x: torch.Tensor) -> torch.Tensor:
    """rcb128's per-64-bit-half step on one 32-bit limb: reverse the bases
    inside each byte, complement (the byte swap is discarded,
    Kmers.cpp:293-316)."""
    c1, c2 = 0x0F0F0F0F, 0x33333333
    x = ((x & c1) << 4) | ((x >> 4) & c1)
    x = ((x & c2) << 2) | ((x >> 2) & c2)
    return x ^ 0xAAAAAAAA


def _shr(limbs: tuple, sh: int) -> tuple:
    """Logical right shift of a 4-limb value."""
    q, r = divmod(sh, 32)
    n = len(limbs)
    zero = torch.zeros_like(limbs[0])
    out = []
    for t in range(n):
        lo = limbs[t + q] if t + q < n else zero
        hi = limbs[t + q + 1] if t + q + 1 < n else zero
        out.append(((lo >> r) | (hi << (32 - r))) & kmers.M32 if r else lo)
    return tuple(out)


def canonized(limbs: tuple, kk: int) -> torch.Tensor:
    """The counter's canonized(seq, kk) (Kmers.cpp:348-353): seq <= its
    broken 128-bit reverse complement."""
    full = tuple(limbs) + tuple(torch.zeros_like(limbs[0])
                                for _ in range(4 - len(limbs)))
    rc = _shr(tuple(_half(x) for x in full), 128 - 2 * kk)
    return ~kmers.less(rc, full)


def get_minimizer(mm: MmerMath, f, canon, ordh, limbs: tuple, kk: int,
                  s0: int, S: int) -> tuple:
    """(pos, rev, hash) of get_minimizer over the kk-mers starting at
    s0 .. s0+S-1 of each lane. f, canon, ordh: (lanes, P) per m-mer start;
    limbs: the kk-mers' limbs, (lanes, S) each."""
    m = mm.m
    clean = 32 - m  # past it, a window of a kk > 32 k-mer reads zeros

    def window(i):
        if kk <= 32 or i <= clean:
            p = s0 + kk - m - i
            return f[:, p:p + S], canon[:, p:p + S], ordh[:, p:p + S]
        p = s0 + kk - 32
        fw = f[:, p:p + S] >> (2 * (i - clean))
        return (fw,) + mm.props(fw)

    fw, cw, hw = window(0)
    pos = torch.zeros_like(fw)
    rev = cw != fw
    hsh = hw
    canz = None
    for i in range(1, kk - m + 1):
        fw, cw, hw = window(i)
        lt = hw < hsh
        eq = hw == hsh
        a = kk - m - i
        up2 = eq & (a < pos)
        up3 = eq & (a == pos)
        if bool(up3.any()):
            if canz is None:
                canz = canonized(limbs, kk)
            up3 = up3 & ~canz
        else:
            up3 = torch.zeros_like(up3)
        pos = torch.where(lt, i, torch.where(up2 | up3, a, pos))
        rev = torch.where(lt | up2, cw != fw, rev & ~up3)
        hsh = torch.where(lt, hw, hsh)
    return pos, rev, hsh


def _pieces(codes_np, k: int, piece: int, overlap: int) -> tuple:
    """The lanes that cover every chunk holding a k-mer: (base starts,
    base lengths, warm-up k-mers, bool: a piece of the same chunk
    follows), in chunk order. A chunk's first lane starts at the chunk
    (as the counter's scan does, warm-up 0); each later one `overlap`
    k-mers before its first kept k-mer."""
    starts, lens = fasta.chunks(codes_np)
    keep = lens >= k
    starts, lens = starts[keep], lens[keep]
    n_k = lens - k + 1
    n_p = -(-n_k // piece)
    chunk = np.repeat(np.arange(starts.size), n_p)
    j = np.arange(chunk.size) - np.repeat(np.cumsum(n_p) - n_p, n_p)
    first = j * piece
    kept = np.minimum(piece, n_k[chunk] - first)
    warm = np.where(j > 0, overlap, 0)
    lane_start = starts[chunk] + first - warm
    lane_len = warm + kept + k - 1
    follows = j + 1 < n_p[chunk]
    return lane_start, lane_len, warm, follows


def lanes(codes_u8: torch.Tensor, starts, lens) -> torch.Tensor:
    """The code runs at `starts` of `lens` bases (numpy int64) as lanes,
    (lanes, max length) int64, zero past each run's end."""
    dev = codes_u8.device
    starts = torch.from_numpy(starts).to(dev)
    lens = torch.from_numpy(lens).to(dev)
    lmax = int(lens.max())
    idx = starts[:, None] + torch.arange(lmax, device=dev)
    inside = idx < (starts + lens)[:, None]
    c = codes_u8[idx.clamp(max=codes_u8.shape[0] - 1)].to(torch.int64)
    return torch.where(inside, c, 0)


def _scan(mm: MmerMath, c: torch.Tensor, lens: torch.Tensor, k: int,
          ) -> tuple:
    """The enumerator over lanes `c` (each from a fresh state): per
    position the emitted k-mer's limbs, its minimizer position and the
    state (pos, rev, hash) packed into one int64, each (lanes, S), and
    the bool mask of the positions that hold a k-mer."""
    dev = c.device
    m = mm.m
    B, L = c.shape
    S = L - k + 1
    fwd16, rc16 = kmers.blocks16(c)
    P = L - m + 1
    f = torch.zeros((B, P), dtype=torch.int64, device=dev)
    for j in range(m):
        f = (f << 2) | c[:, j:j + P]
    canon, ordh = mm.props(f)
    is_rc = canon != f

    def limbs_at(kk, s0, n):
        return kmers.kmer_limbs(fwd16, rc16,
                                torch.arange(s0, s0 + n, device=dev), kk)

    # the fresh lane's state: get_minimizer over its first k-1 bases
    init_f, _ = limbs_at(k - 1, 0, 1)
    pos, rev, hsh = (x[:, 0] for x in get_minimizer(
        mm, f, canon, ordh, init_f, k - 1, 0, 1))
    kf, kr = limbs_at(k, 0, S)
    del fwd16, rc16
    r_pos, r_rev, r_h = get_minimizer(mm, f, canon, ordh, kf, k, 0, S)
    o_pos = torch.empty((B, S), dtype=torch.int64, device=dev)
    o_rev = torch.empty((B, S), dtype=torch.bool, device=dev)
    o_h = torch.empty((B, S), dtype=torch.int64, device=dev)
    km = k - m
    for s in range(S):
        p = s + km
        pos = pos + 1
        exp = pos > km
        imp = ~exp & (ordh[:, p] < hsh)
        pos = torch.where(exp, r_pos[:, s], torch.where(imp, 0, pos))
        rev = torch.where(exp, r_rev[:, s], torch.where(imp, is_rc[:, p],
                                                        rev))
        hsh = torch.where(exp, r_h[:, s], torch.where(imp, ordh[:, p], hsh))
        o_pos[:, s] = pos
        o_rev[:, s] = rev
        o_h[:, s] = hsh
    ok = torch.arange(S, device=dev)[None, :] <= (lens - k)[:, None]
    limbs = tuple(torch.where(o_rev, r, f_) for f_, r in zip(kf, kr))
    idx = torch.where(o_rev, km - o_pos, o_pos)
    state = (o_h << 7) | (o_pos << 1) | o_rev.to(torch.int64)
    return limbs, idx, state, ok


def emission_keys(codes_u8: torch.Tensor, k: int, m: int,
                  piece: int = 4096, overlap: int = 1024,
                  block: int = 1 << 26) -> tuple:
    """Every emission of the chunks of `codes_u8`: (limbs of the emitted
    k-mer, mini_idx), each (n_emissions,) int64, chunks in order,
    positions in order. Lanes of at most `piece` kept k-mers run in
    blocks of about `block` positions.

    The overlap is far past what pieces need: on random bases, of 5,854
    pieces at k=63, m=21 the first shared state came at a median of 14
    k-mers, 1 in 1,000 at 154 or more, the latest at 227 (the low-64-bit
    rescan keeps a piece's state apart longer); at k=31 at 0-18."""
    if overlap > piece:
        raise ValueError("an overlap lies inside the piece before it")
    dev = codes_u8.device
    mm = MmerMath(m, dev)
    starts, lens, warm, follows = _pieces(codes_u8.cpu().numpy(), k, piece,
                                          overlap)
    width = piece + overlap + k - 1
    per = max(1, block // width)
    out_limbs, out_idx, heads, tails = [], [], [], []
    for a in range(0, starts.size, per):
        sl = slice(a, a + per)
        c = lanes(codes_u8, starts[sl], lens[sl])
        ln = torch.from_numpy(lens[sl]).to(dev)
        limbs, idx, state, ok = _scan(mm, c, ln, k)
        del c
        w = torch.from_numpy(warm[sl]).to(dev)
        pos = torch.arange(ok.shape[1], device=dev)[None, :]
        keep = ok & (pos >= w[:, None])
        out_limbs.append(tuple(x[keep] for x in limbs))
        out_idx.append(idx[keep])
        # states over each overlap, from both of its pieces
        if warm[sl].any():
            heads.append(state[w > 0][:, :overlap])
        if follows[sl].any():
            fol = torch.from_numpy(follows[sl]).to(dev)
            last = (ln - k + 1)[fol][:, None] - overlap + torch.arange(
                overlap, device=dev)
            tails.append(torch.gather(state[fol], 1, last))
        del limbs, idx, state, ok, keep
    if not out_idx:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return tuple(z for _ in range(kmers.n_limbs(k))), z
    if heads:
        met = (torch.cat(heads) == torch.cat(tails)).any(dim=1)
    else:
        met = torch.ones(0, dtype=torch.bool)
    if not bool(met.all()):
        raise RuntimeError(
            f"{int((~met).sum())} of {met.numel()} pieces never met the "
            f"state of the piece before within {overlap} k-mers")
    return (tuple(torch.cat([p[t] for p in out_limbs])
                  for t in range(kmers.n_limbs(k))), torch.cat(out_idx))
