"""The comparison has to fail what is wrong: the control (the reference
with its keys cut to 32-bit fingerprints) at a size where fingerprints
collide, and each fault a cell can have, planted under a whole run with
the look for a card skipped. (Neither cell spans chips, so there is no
exchange to leave out.)"""

import io
import json
import types

import pytest
import torch

from benchmark import run

from conftest import ROOT


def run_cell(root, cell, seed=77):
    out = io.StringIO()
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "0", "--trace", "0"], device="cpu", root=root,
                    out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell,size", [
    ("k31-chr1-count", dict(bases=1_500_000)),
    ("k63-hifi-count", dict(genome_bases=700_000, coverage=2,
                            read_min=2000, read_max=4000))])
def test_control_fails(cell, size):
    real = run.Cell(ROOT, cell)
    cfg = json.loads(json.dumps(real.config))
    cfg["index_input"].update(size)
    wl = json.loads(json.dumps(real.workload))
    wl["traffic"].update(query_reads=10)
    fake = types.SimpleNamespace(config=cfg, workload=wl)
    got = real.driver().control(fake, 4242, torch.device("cpu"))
    assert got["count_mismatch"] > wl["limits"]["count_mismatch"]
    assert got["distinct_gap"] > wl["limits"]["distinct_gap"]


def _unchanged(mp):
    from brisk_tpu_torch import api
    mp.setattr(api.Brisk, "insert_file", lambda self, path: None)


def _half_left_out(mp):
    from brisk_tpu_torch import api
    orig = api.Brisk._records

    def half(self, path):
        return (r for i, r in enumerate(orig(self, path)) if i % 2 == 0)
    mp.setattr(api.Brisk, "_records", half)


def _count_altered(mp):
    from brisk_tpu_torch.index import sklstore
    orig = sklstore.finalize_device

    def altered(state, k, m, b):
        out = orig(state, k, m, b)
        out.data[0] += 1
        return out
    mp.setattr(sklstore, "finalize_device", altered)


def _key_altered(mp):
    """Every other entry read back under another minimizer position: the
    canonical counts stay, the keys do not."""
    from brisk_tpu_torch.index import readout
    orig = readout.entries_u64

    def altered(state, params):
        bucket, hi, lo, idx, cnt = orig(state, params)
        idx = idx.copy()
        idx[::2] = (idx[::2] + 1) % (params.k - params.m + 1)
        return bucket, hi, lo, idx, cnt
    mp.setattr(readout, "entries_u64", altered)


def _answer_altered(mp):
    from brisk_tpu_torch import api
    orig = api.Brisk.query_file
    mp.setattr(api.Brisk, "query_file",
               lambda self, path: orig(self, path) + 1)


@pytest.mark.parametrize("cell", ["tiny31", "tiny63"])
@pytest.mark.parametrize("fault,number", [
    (_unchanged, "count_mismatch"), (_half_left_out, "count_mismatch"),
    (_count_altered, "count_mismatch"), (_key_altered, "key_mismatch"),
    (_answer_altered, "query_gap")])
def test_fault_makes_the_run_incorrect(tiny_root, monkeypatch, cell, fault,
                                       number):
    fault(monkeypatch)
    res = run_cell(tiny_root, cell)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
    assert res["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["k31-chr1-count", "k63-hifi-count"])
def test_control_fails_at_cell_size(card, cell):
    c = run.Cell(ROOT, cell)
    got = c.driver().control(c, 90210, card)
    assert got["count_mismatch"] > c.workload["limits"]["count_mismatch"]
