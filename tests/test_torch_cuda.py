"""Tests that need a CUDA card (marker `cuda`): the CUDA span expansion
kernel against its plain PyTorch version, a small index on the card
against the pure-Python oracle, and the k = 63 streaming insert and
consolidate_all on the card against the port on the CPU, array for
array. They skip on a machine without a card.
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


def _rows(skl, s_max: int = 8) -> dict:
    """Host uint32 copy of the used rows and padded slots of an arena
    (s_max is 8 at both configurations tested here)."""
    cols = sklstore.to_numpy(skl)
    n, nd = cols["n_rows"], cols["n_fin_rows"]
    out = {f: cols[f][..., :n] for f in ("bucket", "meta", "nucs", "offs")}
    out["data"] = cols["data"][:nd * s_max]
    out["n"] = (n, nd, cols["n_fin_kmers"])
    return out


def _assert_rows_equal(a: dict, c: dict) -> None:
    assert a["n"] == c["n"]
    for f in ("bucket", "meta", "nucs", "offs", "data"):
        np.testing.assert_array_equal(a[f], c[f], err_msg=f)


def test_k63_stream_on_card_matches_cpu(device, tmp_path):
    """The k = 63 streaming insert (long records and the short-read
    route) gives the CPU port's arena on the card, after insert and
    after finalize, and finalize launches the kernel at W = 6."""
    rng = np.random.default_rng(4)
    reads = ["".join("ACGT"[c] for c in rng.integers(0, 4, 150))
             for _ in range(300)]
    short = tmp_path / "reads.fa"
    short.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    for path in ("data/test.fa", str(short)):
        built = []
        for dev in ("cpu", device):
            b = Brisk(Parameters(63, 21, 14), batch=16, window=128,
                      device=dev)
            b.insert_file(path)
            b._drain()
            built.append((b, _rows(b.skl)))
        (cpu, cpu_ins), (card, card_ins) = built
        _assert_rows_equal(cpu_ins, card_ins)
        before = kernels.LAUNCHES["expand_span_jmajor"]
        card.finalize()
        assert kernels.LAUNCHES["expand_span_jmajor"] > before
        cpu.finalize()
        _assert_rows_equal(_rows(cpu.skl), _rows(card.skl))
        assert card.counts_dict() == pyref.count_fasta(path, 63, 21)
        assert card.n_emitted == cpu.n_emitted
        assert card.skl.bucket.device.type == "cuda"


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14)])
def test_consolidate_all_on_card_matches_cpu(device, k, m, b):
    """Three finalized segments with cross-segment duplicates: the carry
    path on the card (kernel, row-major transpose, 2^18 chunks, dead-row
    drop) gives the CPU port's arena."""
    src = Brisk(Parameters(k, m, b), batch=16, window=128, device="cpu")
    for path in ("data/test.fa", "data/debug_test.fa", "data/test.fa"):
        src.insert_file(path)
        src.finalize()
    cols = sklstore.to_numpy(src.skl)
    cpu = sklstore.consolidate_all(sklstore.from_numpy(cols, "cpu"), k, m, b)
    before = kernels.LAUNCHES["expand_span_jmajor"]
    card = sklstore.consolidate_all(sklstore.from_numpy(cols, device),
                                    k, m, b)
    assert kernels.LAUNCHES["expand_span_jmajor"] == before + 1
    assert int(card.n_rows) < cols["n_rows"]
    _assert_rows_equal(_rows(cpu), _rows(card))
