"""The port's persistence and export paths against brisk_tpu on the CPU:
save (loaded by both packages), the KFF writers and reader, and the
counter CLI. Exact comparisons, array for array and byte for byte."""

import numpy as np
import pytest
import torch

from brisk_tpu.api import Brisk as JBrisk
from brisk_tpu.apps import counter as j_counter
from brisk_tpu.io import kff as j_kff
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch.api import Brisk as TBrisk
from brisk_tpu_torch.apps import counter as t_counter
from brisk_tpu_torch.index import sklstore as t_skl
from brisk_tpu_torch.io import kff as t_kff
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters
from tests.test_torch_maintenance import (CONFIGS, GEOM, _cols, _rand_seq,
                                          _segmented_arena)

torch.set_num_threads(2)


@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_save_loads_in_both_packages(k, m, b, tmp_path):
    rng = np.random.default_rng(k + 7)
    tb = TBrisk(Parameters(k, m, b), device="cpu", **GEOM)
    tb.insert_sequence(_rand_seq(rng, 400))
    tb.finalize()
    tb.insert_sequence(_rand_seq(rng, 300))  # saved after a finalize
    path = str(tmp_path / "idx.npz")
    tb.save(path)
    z = np.load(path)
    for f in ("skl_bucket", "skl_meta", "skl_nucs", "skl_data", "skl_offs"):
        assert z[f].dtype == np.uint32, f
    cols = _cols(tb.skl)
    for f in ("bucket", "meta", "nucs", "data", "offs"):
        np.testing.assert_array_equal(z["skl_" + f], cols[f])
    jl = JBrisk.load(path, **{g: GEOM[g] for g in ("batch", "window")})
    tl = TBrisk.load(path, device="cpu",
                     **{g: GEOM[g] for g in ("batch", "window")})
    want = tb.counts_dict()
    assert jl.counts_dict() == tl.counts_dict() == want
    assert tl._skl_segments == jl._skl_segments == tb._skl_segments
    assert (tl.n_emitted, tl.n_superkmers) == (jl.n_emitted,
                                               jl.n_superkmers)
    assert tl.stats() == jl.stats()


@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_kff_bytes_match(k, m, b, tmp_path):
    """write_index_skl / write_index_skl_many / write_index write the JAX
    writer's bytes for the same arena; read_index agrees."""
    js = _segmented_arena(k, m, b, seed=k + 3)
    ts = t_skl.from_numpy(_cols(js), "cpu")
    jp, tp = JParameters(k, m, b), Parameters(k, m, b)
    outs = {}
    for tag, mod, st, p in (("j", j_kff, js, jp), ("t", t_kff, ts, tp)):
        one, many = tmp_path / f"{tag}1.kff", tmp_path / f"{tag}2.kff"
        mod.write_index_skl(str(one), st, p)
        mod.write_index_skl_many(str(many), [st, st], p)
        outs[tag] = (one.read_bytes(), many.read_bytes())
    assert outs["t"] == outs["j"]
    counts, kk, mm = t_kff.read_index(str(tmp_path / "t1.kff"))
    assert (kk, mm) == (k, m)
    assert counts == j_kff.read_index(str(tmp_path / "j1.kff"))[0]
    jb = JBrisk(jp, **GEOM)
    jb.skl = js
    jb._skl_segments = [(0, int(js.n_fin_rows))]
    assert counts == jb.counts_dict()
    # the per-k-mer form from the transient view
    jv = jb._expanded_view()
    tv = t_skl.expanded_state(ts, k, m, b)
    j_kff.write_index(str(tmp_path / "jp.kff"), jv, jp)
    t_kff.write_index(str(tmp_path / "tp.kff"), tv, tp)
    assert (tmp_path / "tp.kff").read_bytes() == \
        (tmp_path / "jp.kff").read_bytes()


def _cli_lines(out: str) -> list:
    """stdout without the device and timing lines."""
    skip = ("Devices:", "Kmer counted elapsed time", "Query elapsed time",
            "kmer / second")
    return [ln for ln in out.splitlines() if not ln.startswith(skip)]


@pytest.mark.parametrize("k,m,b", CONFIGS)
def test_counter_cli_matches_jax(k, m, b, tmp_path, capsys):
    out = str(tmp_path / "idx.kff")
    argv = ["-f", "data/test.fa", "-q", "data/test.fa", "-k", str(k), "-m",
            str(m), "-b", str(b), "--mode", "2", "-o", out, "--batch", "16",
            "--window", "128"]
    j_counter.main(argv)
    j_out = capsys.readouterr().out
    j_bytes = open(out, "rb").read()
    t_counter.main(argv + ["--device", "cpu"])
    t_out = capsys.readouterr().out
    assert "All counts are correct !" in t_out
    assert "Devices: cpu" in t_out
    assert _cli_lines(t_out) == _cli_lines(j_out)
    assert open(out, "rb").read() == j_bytes
    assert t_kff.read_index(out)[0] == pyref.count_fasta("data/test.fa", k, m)
