"""Tests that need a CUDA card (marker `cuda`): the CUDA span expansion
kernel against its plain PyTorch version, and a small index on the card
against the pure-Python oracle. They skip on a machine without a card.
This file imports no jax; on the card's machine (which has no jax) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from brisk_tpu_torch import kernels
from brisk_tpu_torch.api import Brisk
from brisk_tpu_torch.index import sklstore
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _span(R, k, m, b, seed):
    cs, s_max, _, nw = sklstore.skl_dims(k, m, b)
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, 1 << (2 * b), R, dtype=np.uint32)
    bucket[rng.random(R) < 0.15] = 0xFFFFFFFF
    meta = rng.integers(0, 1 << 32, R, dtype=np.uint32)  # any meta
    nucs = rng.integers(0, 1 << 32, (nw, R), dtype=np.uint32)
    cols = [torch.from_numpy(a.view(np.int32).copy())
            for a in (bucket, meta, nucs)]
    return cols, s_max


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14), (63, 61, 1)])
@pytest.mark.parametrize("R", [1000, 1024, 12288])
def test_kernel_matches_plain_version(device, k, m, b, R):
    (sb, sm, sn), s_max = _span(R, k, m, b, seed=R + k)
    want = sklstore._expand_span_jmajor_torch(sb, sm, sn, k, m, b, s_max)
    before = kernels.LAUNCHES["expand_span_jmajor"]
    got = kernels.expand_span_jmajor(sb.to(device), sm.to(device),
                                     sn.to(device), k, m, b, s_max)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expand_span_jmajor"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_kernel_wrapper_checks(device):
    (sb, sm, sn), s_max = _span(1024, 31, 11, 8, seed=1)
    sb, sm, sn = sb.to(device), sm.to(device), sn.to(device)
    with pytest.raises(TypeError):
        kernels.expand_span_jmajor(sb.long(), sm, sn, 31, 11, 8, s_max)
    with pytest.raises(ValueError):
        kernels.expand_span_jmajor(sb, sm, sn[:, ::2], 31, 11, 8, s_max)


@pytest.mark.parametrize("path", ["data/test.fa", "data/debug_test.fa"])
def test_index_on_card_matches_oracle(device, path):
    idx = Brisk(Parameters(31, 11, 8), batch=16, window=64, device=device)
    before = kernels.LAUNCHES["expand_span_jmajor"]
    idx.insert_file(path)
    assert idx.counts_dict() == pyref.count_fasta(path, 31, 11)
    assert kernels.LAUNCHES["expand_span_jmajor"] > before
    assert idx.skl.bucket.device.type == "cuda"
