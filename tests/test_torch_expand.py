"""The span expansion (the port's one CUDA kernel) on the CPU: its plain
PyTorch version (sklstore._expand_span_jmajor_torch) against the JAX
package's lax version and its Pallas kernel in interpret mode, the
super-k-mer window identity the kernel's fast path relies on, the
wrapper's checks, plus the shared stable lexicographic sort. Exact
comparisons throughout. The CUDA kernel itself is held against the same
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import sklstore as j_skl
from brisk_tpu_torch import _u32, bench_expand, kernels
from brisk_tpu_torch.index import sklstore as t_skl
from brisk_tpu_torch.index import store

torch.set_num_threads(2)

CONFIGS = {31: (31, 11, 8), 63: (63, 21, 14)}


def _random_span(R, k, seed=0):
    """Random but invariant-respecting span rows (the recipe of
    tests/test_pallas_expand.py): bucket < 2^(2b) or dead, size in
    [1, s_max], mini_idx plausible. Returns numpy uint32 columns."""
    K, M, B = CONFIGS[k]
    cs, s_max, nt_max, nw = j_skl.skl_dims(K, M, B)
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, 1 << (2 * B), R, dtype=np.uint32)
    dead = rng.random(R) < 0.15
    bucket[dead] = 0xFFFFFFFF
    size = rng.integers(1, s_max + 1, R, dtype=np.uint32)
    mini = (size - 1) + rng.integers(0, cs - s_max + 1, R,
                                     dtype=np.uint32) + 3
    meta = ((size & 0xFF) | ((mini & 0xFF) << 8)).astype(np.uint32)
    nucs = rng.integers(0, 1 << 32, (nw, R), dtype=np.uint32)
    return bucket, meta, nucs, s_max


def _both(bucket, meta, nucs):
    j = tuple(jnp.asarray(x) for x in (bucket, meta, nucs))
    t = tuple(_u32.from_np(x, "cpu") for x in (bucket, meta, nucs))
    return j, t


@pytest.mark.parametrize("k", [31, 63])
@pytest.mark.parametrize("R", [1024, 4096, 12288])
def test_torch_jmajor_matches_lax(R, k):
    bucket, meta, nucs, s_max = _random_span(R, k, seed=R + k)
    (jb, jm, jn), (tb, tm, tn) = _both(bucket, meta, nucs)
    want = np.asarray(j_skl._expand_span_jmajor_lax(jb, jm, jn,
                                                    *CONFIGS[k], s_max))
    got = t_skl._expand_span_jmajor_torch(tb, tm, tn, *CONFIGS[k], s_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32.to_np(got), want)


@pytest.mark.parametrize("k", [31, 63])
def test_torch_jmajor_matches_pallas_interpret(k):
    """The exact TPU kernel body, in Pallas interpret mode."""
    bucket, meta, nucs, s_max = _random_span(1024, k, seed=7 * k)
    (jb, jm, jn), (tb, tm, tn) = _both(bucket, meta, nucs)
    want = np.asarray(j_skl._expand_span_jmajor_pallas(
        jb, jm, jn, *CONFIGS[k], s_max, interpret=True))
    got = t_skl._expand_span_jmajor_torch(tb, tm, tn, *CONFIGS[k], s_max)
    np.testing.assert_array_equal(_u32.to_np(got), want)


@pytest.mark.parametrize("k", [31, 63])
def test_torch_jmajor_garbage_meta(k):
    """Invariant-violating meta (u32 wraparound in the hole offset,
    shifts of 128 bits or more) still matches the reference bit for
    bit: the CUDA kernel is held to the same contract."""
    bucket, _, nucs, s_max = _random_span(1024, k, seed=3)
    meta = np.random.default_rng(5).integers(0, 1 << 32, 1024,
                                             dtype=np.uint32)
    (jb, jm, jn), (tb, tm, tn) = _both(bucket, meta, nucs)
    want = np.asarray(j_skl._expand_span_jmajor_lax(jb, jm, jn,
                                                    *CONFIGS[k], s_max))
    got = t_skl._expand_span_jmajor_torch(tb, tm, tn, *CONFIGS[k], s_max)
    np.testing.assert_array_equal(_u32.to_np(got), want)


@pytest.mark.parametrize("k", [31, 63])
def test_rowmajor_expand_span(k):
    """sklstore._expand_span on CPU tensors: the plain row-major version,
    equal to the reference's _expand_span, and no launch of either
    layout."""
    bucket, meta, nucs, s_max = _random_span(4096, k, seed=11)
    (jb, jm, jn), (tb, tm, tn) = _both(bucket, meta, nucs)
    jk, jok = j_skl._expand_span(jb, jm, jn, *CONFIGS[k], s_max)
    before = dict(kernels.LAUNCHES)
    tk, tok = t_skl._expand_span(tb, tm, tn, *CONFIGS[k], s_max)
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(_u32.to_np(tk), np.asarray(jk))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_dispatch_uses_plain_version_on_cpu():
    bucket, meta, nucs, s_max = _random_span(1024, 31, seed=2)
    _, (tb, tm, tn) = _both(bucket, meta, nucs)
    before = kernels.LAUNCHES["expand_span_jmajor"]
    got = t_skl._expand_span_jmajor(tb, tm, tn, *CONFIGS[31], s_max)
    want = t_skl._expand_span_jmajor_torch(tb, tm, tn, *CONFIGS[31], s_max)
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["expand_span_jmajor"] == before


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never falls back: a CPU tensor is an error."""
    bucket, meta, nucs, s_max = _random_span(1024, 31, seed=2)
    _, (tb, tm, tn) = _both(bucket, meta, nucs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.expand_span_jmajor(tb, tm, tn, *CONFIGS[31], s_max)


@pytest.mark.parametrize("layout", ["jmajor", "rowmajor", "colmajor", None])
def test_kernel_wrapper_checks_before_any_build(layout):
    """kernels.expand_span rejects a bad layout and CPU tensors before it
    builds anything (this machine has no nvcc: a build attempt would
    raise RuntimeError instead)."""
    bucket, meta, nucs, s_max = _random_span(1024, 31, seed=2)
    _, (tb, tm, tn) = _both(bucket, meta, nucs)
    before = dict(kernels.LAUNCHES)
    match = "CUDA tensor" if layout in kernels.LAYOUTS else "layout"
    with pytest.raises(ValueError, match=match):
        kernels.expand_span(tb, tm, tn, *CONFIGS[31], s_max, layout=layout)
    assert kernels.LAUNCHES == before
    assert not kernels._libs


@pytest.mark.parametrize("s_max", [0, 9])
def test_kernel_wrapper_rejects_s_max_before_any_build(s_max):
    """s_max is the kernel's one compile-time shape (a library per value,
    1..8, the cap of sklstore.skl_dims): any other value raises before a
    build is tried."""
    bucket, meta, nucs, _ = _random_span(1024, 31, seed=2)
    _, (tb, tm, tn) = _both(bucket, meta, nucs)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kernels.expand_span(tb, tm, tn, *CONFIGS[31], s_max)
    assert not kernels._libs


# -- the identity the CUDA kernel's fast path relies on --------------------

def _regular(bucket, meta, k, m, b):
    """The kernel's per-row predicate (csrc/expand_span.cu, make_row):
    live, bucket < 4^b, 1 <= size <= s_max, size - 1 <= mini <= k - b."""
    s_max = t_skl.skl_dims(k, m, b)[1]
    size = meta & 0xFF
    mini = (meta >> 8) & 0xFF
    return ((bucket != 0xFFFFFFFF) & (bucket < (1 << (2 * b)))
            & (size >= 1) & (size <= s_max) & (size - 1 <= mini)
            & (mini <= k - b))


def _superkmer_windows(bucket, meta, nucs, k, m, b, s_max):
    """J-major keys of every live row computed as the kernel's fast path
    does, in Python ints: rebuild the row's super-k-mer once with the
    bucket re-inserted at bit 2*mini, K = S << 8, then per slot
    ((K >> 2d) & M) | bucket << (8+2k) | (h - suffix_reduc), d =
    size-1-j, h = mini-d (u32), M the bits [8, 8+2k)."""
    W = store.key_words(k, b)
    R = bucket.shape[0]
    sr = (m - b + 1) // 2
    M = ((1 << (2 * k)) - 1) << 8
    out = np.full((W, s_max * R), 0xFFFFFFFF, dtype=np.uint32)
    for r in range(R):
        bk, mt = int(bucket[r]), int(meta[r])
        if bk == 0xFFFFFFFF:
            continue
        size, mini = mt & 0xFF, (mt >> 8) & 0xFF
        n = sum(int(nucs[i, r]) << (32 * i) for i in range(nucs.shape[0]))
        lo = n & ((1 << (2 * mini)) - 1)
        S = lo | (bk << (2 * mini)) | ((n >> (2 * mini)) << (2 * mini + 2 * b))
        K = S << 8
        for j in range(min(size, s_max)):
            d = size - 1 - j
            fm = (mini - d - sr) & 0xFFFFFFFF
            key = ((K >> (2 * d)) & M) | (bk << (8 + 2 * k)) | fm
            for w in range(W):
                out[w, j * R + r] = (key >> (32 * (W - 1 - w))) & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14), (63, 61, 1)])
def test_superkmer_window_identity(k, m, b):
    """On regular rows, the windows of the once-rebuilt super-k-mer equal
    the plain version's per-slot re-insertion, slot for slot; on rows with
    any meta, every row where they differ is one the predicate calls
    irregular (so the kernel sends it down its per-slot path)."""
    R = 600
    for garbage in (0.0, 1.0):
        sb, sm, sn, s_max = bench_expand.span_rows(R, k, m, b, seed=k + m,
                                                   device="cpu",
                                                   garbage=garbage)
        want = _u32.to_np(t_skl._expand_span_jmajor_torch(
            sb, sm, sn, k, m, b, s_max))
        bucket, meta, nucs = (_u32.to_np(t) for t in (sb, sm, sn))
        got = _superkmer_windows(bucket, meta, nucs, k, m, b, s_max)
        regular = _regular(bucket.astype(np.int64), meta.astype(np.int64),
                           k, m, b)
        slot_regular = np.tile(regular, s_max)
        row_differs = np.zeros(R, bool)
        for j in range(s_max):
            row_differs |= (got[:, j * R:(j + 1) * R]
                            != want[:, j * R:(j + 1) * R]).any(axis=0)
        assert not (row_differs & regular).any()
        np.testing.assert_array_equal(got[:, slot_regular],
                                      want[:, slot_regular])
        if garbage == 0.0:
            live = bucket != 0xFFFFFFFF
            assert (regular == live).all()  # insert-shaped rows: all regular
        else:
            # garbage meta: most live rows are irregular, and some of
            # them really differ, so the predicate has work to do
            live = bucket != 0xFFFFFFFF
            assert (live & ~regular).sum() > R // 2
            assert row_differs.sum() > 0


@pytest.mark.parametrize("W,n", [(1, 50), (3, 4000), (6, 777)])
def test_lexsort_matches_numpy(W, n):
    rng = np.random.default_rng(W * n)
    # few distinct values per word: many ties, and values >= 2^31
    words = rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                                dtype=np.uint32), (W, n))
    perm = _u32.lexsort([_u32.from_np(w, "cpu") for w in words])
    want = np.lexsort(words[::-1])  # np.lexsort: last key is primary
    np.testing.assert_array_equal(perm.numpy(), want)


def test_lexsort_along_dim1():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 4, (2, 5, 64)).astype(np.uint32)
    words[0, :, ::3] = 0xF0000000
    perm = _u32.lexsort([_u32.from_np(w, "cpu") for w in words], dim=1)
    for c in range(5):
        want = np.lexsort((words[1, c], words[0, c]))
        np.testing.assert_array_equal(perm[c].numpy(), want)
