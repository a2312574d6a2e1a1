"""The payload insert program split for the card's CUDA graphs, on the
CPU: pipeline.payload_flush_body plus payload.append_masked against
brisk_tpu's jitted insert_windows_payload, flush after flush with the
window chain carried, at k=31 (a record whose windows fail their
certificate) and k=63, and across the compactions BriskData._room_for
makes when the log is full: the state's key and lane columns whole,
n_used and n_sorted, n_km, the certificates, end states and the chain,
bit for bit. Inputs come from the repository's FASTA fixtures through
brisk_tpu's WindowPacker, in stacks of S = 2 batches of 16 lanes."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import payload as j_payload
from brisk_tpu.index import pipeline as j_pipe
from brisk_tpu.io import windows as j_win
from brisk_tpu.oracle import pyref
from brisk_tpu_torch.data_api import BriskData
from brisk_tpu_torch.index import payload as t_payload
from brisk_tpu_torch.index import pipeline as t_pipe
from brisk_tpu_torch.index import store as t_store
from brisk_tpu_torch.params import Parameters

torch.set_num_threads(2)

S = 2
LANES = 16
K31 = (31, 11, 8)
K63 = (63, 21, 14)


def _repair_fixture(path) -> str:
    """One record whose windows need exact repairs (equal-hash minimizer
    ties across window seams) at batch 16, window 64."""
    rng = random.Random(5)

    def rs(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    path.write_text(">repair\n" + rs(300) + "ACGTTGCA" * 200 + rs(300)
                    + "AAAAAAAAAAAAC" * 80 + rs(300) + "\n")
    return str(path)


def _stacks(path, kmb, window, n):
    """The first n stacks of S window batches of a FASTA at a BriskData's
    geometry (its bumped window): [(codes (S, B, L_buf) uint8,
    valid_start, valid_end, pos0 (S, B) int64, rec (S*B,))], the
    packer."""
    geo = BriskData(Parameters(*kmb), batch=LANES, window=window, stack=S,
                    device="cpu")
    packer = j_win.WindowPacker(kmb[0], kmb[1], LANES, l_out=geo.window)
    batches = list(packer.pack(pyref.read_fasta_chunks(path)))
    assert len(batches) >= n * S, "need n full stacks"
    stacks = []
    for i in range(0, n * S, S):
        st = batches[i:i + S]
        stacks.append((np.stack([bt.codes for bt in st]),
                       np.stack([bt.valid_start for bt in st]),
                       np.stack([bt.valid_end for bt in st]),
                       np.stack([bt.win.astype(np.int64) * packer.useful
                                 for bt in st]),
                       np.concatenate([bt.rec for bt in st])))
    return stacks, packer


def _assert_states(js, ts, what: str) -> None:
    got = t_payload.to_numpy(ts)
    assert (got["n_sorted"], got["n_used"]) == (int(js.n_sorted),
                                                int(js.n_used)), what
    np.testing.assert_array_equal(got["keys"], np.asarray(js.keys),
                                  err_msg=what)
    np.testing.assert_array_equal(got["data"], np.asarray(js.data),
                                  err_msg=what)


CASES = {
    # name: (k, m, b), FASTA (None: the repair fixture), window, width,
    # flushes, log capacity in stacks of columns
    "k31-repair": (K31, None, 64, 2, 2, 4),
    "k63": (K63, "data/debug_test.fa", 128, 3, 3, 4),
    "k31-compact": (K31, "data/debug_test.fa", 96, 2, 4, 1.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_payload_body_and_append_match_brisk_tpu(case, tmp_path):
    """Flushes through payload_flush_body + append_masked, the chain
    carried, against brisk_tpu's jitted insert_windows_payload, with
    BriskData's room rule before each (compact both logs when the stack
    would overflow, then grow): the states whole, n_km, cert, ends and
    the chain after every flush. The repair case holds lanes that fail
    their certificate; the compact case crosses compactions."""
    kmb, path, window, width, n, stacks_cap = CASES[case]
    k, m, b = kmb
    if path is None:
        path = _repair_fixture(tmp_path / "repair.fa")
    kinds = ("sum",) + ("max",) * (width - 1)
    stacks, packer = _stacks(path, kmb, window, n)
    cols = S * LANES * packer.l_out
    W = t_store.key_words(k, b)
    cap = int(stacks_cap * cols)
    js = j_payload.empty(cap, W, width)
    ts = t_payload.empty(cap, W, width, "cpu")
    jch, tch = j_pipe.zero_chain(), t_pipe.zero_chain()
    compactions = failed = 0
    for f, (codes, vs, ve, pos0, rec) in enumerate(stacks):
        if int(js.n_used) + cols > js.keys.shape[1]:
            js = j_payload.compact(js, kinds)
            ts = t_payload.compact(ts, kinds)
            compactions += 1
        js = j_payload.ensure_room(js, cols)
        ts = t_payload.ensure_room(ts, cols)
        js, j_km, j_cert, j_ends, jch = j_pipe.insert_windows_payload(
            js, jnp.asarray(codes), jnp.asarray(vs), jnp.asarray(ve),
            jnp.asarray(pos0.astype(np.uint32)), jch, k=k, m=m, b=b,
            width=width)
        n_used0 = ts.n_used
        keys, lanes, t_km, t_cert, t_ends, tch = t_pipe.payload_flush_body(
            torch.from_numpy(codes).to(torch.int64), torch.from_numpy(vs),
            torch.from_numpy(ve), torch.from_numpy(pos0), tch, k, m, b,
            width)
        assert keys.shape == (W, cols) and lanes.shape == (width, cols)
        assert keys.dtype == lanes.dtype == torch.int32
        ts = t_payload.append_masked(ts, keys, lanes)
        assert ts.n_used == n_used0 + cols
        _assert_states(js, ts, f"{case} flush {f}")
        assert int(t_km) == int(j_km)
        np.testing.assert_array_equal(t_cert.numpy(), np.asarray(j_cert))
        for a, c in zip(j_ends, t_ends):
            np.testing.assert_array_equal(
                c.numpy().astype(np.int64), np.asarray(a).astype(np.int64))
        (jend, jex), (tend, tex) = jch, tch
        assert bool(jex) == bool(tex)
        assert [int(x) for x in jend] == [int(x) for x in tend]
        failed += int((~t_cert.numpy().reshape(-1) & (rec >= 0)).sum())
    assert (compactions > 0) == (case == "k31-compact")
    if case == "k31-repair":
        assert failed > 0
    assert ts.n_used > 0


def test_append_masked_matches_append_and_raises_when_full():
    """append_masked of columns payload.append would tombstone equals
    append on the same valid mask, in place at n_used; past capacity it
    raises and writes nothing."""
    rng = np.random.default_rng(3)
    W, D, n = 3, 2, 50
    keys = torch.from_numpy(rng.integers(-2**31, 2**31, (W, n),
                                         dtype=np.int64).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, (D, n),
                                         dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.7)
    a = t_payload.append(t_payload.empty(128, W, D), keys, vals, valid)
    masked = (torch.where(valid[None], keys, -1),
              torch.where(valid[None], vals, 0))
    c = t_payload.append_masked(t_payload.empty(128, W, D), *masked)
    assert (a.n_used, a.n_sorted) == (c.n_used, c.n_sorted) == (n, 0)
    assert torch.equal(a.keys, c.keys) and torch.equal(a.data, c.data)
    c = t_payload.append_masked(c, *masked)
    assert c.n_used == 2 * n
    assert torch.equal(c.keys[:, n:2 * n], a.keys[:, :n])
    before = (c.keys.clone(), c.data.clone())
    with pytest.raises(ValueError, match="overflow capacity"):
        t_payload.append_masked(c, *masked)  # 150 columns > 128
    assert torch.equal(c.keys, before[0]) and torch.equal(c.data, before[1])
