"""The span expansion (the port's one CUDA kernel) on the CPU: its plain
PyTorch version (sklstore._expand_span_jmajor_torch) against the JAX
package's lax version and its Pallas kernel in interpret mode, plus the
shared stable lexicographic sort. Exact comparisons throughout. The
CUDA kernel itself is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import sklstore as j_skl
from brisk_tpu_torch import _u32, kernels
from brisk_tpu_torch.index import sklstore as t_skl

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
    bucket, meta, nucs, s_max = _random_span(4096, k, seed=11)
    (jb, jm, jn), (tb, tm, tn) = _both(bucket, meta, nucs)
    jk, jok = j_skl._expand_span(jb, jm, jn, *CONFIGS[k], s_max)
    tk, tok = t_skl._expand_span(tb, tm, tn, *CONFIGS[k], s_max)
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
