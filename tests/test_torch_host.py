"""The host modules copied into the port behave like the originals, and
the port never imports jax or the JAX package."""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brisk_tpu_torch
from brisk_tpu import native as j_native
from brisk_tpu.index import keying as j_keying
from brisk_tpu.index import readout as j_readout
from brisk_tpu.index import store as j_store
from brisk_tpu.io import windows as j_windows
from brisk_tpu.oracle import pyref as j_pyref
from brisk_tpu.params import Parameters as JParameters
from brisk_tpu_torch import _u32
from brisk_tpu_torch import native as t_native
from brisk_tpu_torch.index import keying as t_keying
from brisk_tpu_torch.index import readout as t_readout
from brisk_tpu_torch.index import store as t_store
from brisk_tpu_torch.io import windows as t_windows
from brisk_tpu_torch.oracle import pyref as t_pyref
from brisk_tpu_torch.params import Parameters

torch.set_num_threads(2)

PKG = os.path.dirname(brisk_tpu_torch.__file__)
FASTAS = ["data/test.fa", "data/debug_test.fa"]


def _records(path):
    return list(j_pyref.read_fasta_chunks(path))


@pytest.mark.parametrize("path", FASTAS)
def test_pack_flat_matches(path):
    recs = _records(path)
    jp = j_windows.WindowPacker(31, 11, 16, l_out=96)
    tp = t_windows.WindowPacker(31, 11, 16, l_out=96)
    jf, tf = list(jp.pack_flat(iter(recs), 3)), list(tp.pack_flat(iter(recs),
                                                                   3))
    assert len(jf) == len(tf) > 1
    for a, b in zip(jf, tf):
        for f in ("chunk4", "valid_start", "valid_end", "rec", "win"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.n_kmers, a.n_records) == (b.n_kmers, b.n_records)


def _bulk_lengths(case, packer):
    """Record lengths of a case of test_pack_stacks_matches."""
    k, lb, u = packer.k, packer.l_buf, packer.useful
    return {
        "short_records": [k - 1, 200, 3, k + 5, k - 2, 450, 1],
        "one_window": [k, lb, lb + 1, k],  # exactly k; exactly one window
        "record_ends": [lb + u, lb + 2 * u, lb + u // 2, lb + 3 * u + 1],
        "partial_batch": [lb + 2 * u],
        "whole_stacks": [lb + 3 * u] * 8,  # 4 windows each
        "strings": [lb + u, k - 1, 2 * lb, k + 3],
    }[case]


@pytest.mark.parametrize("k,m,l_out", [(31, 15, 64), (63, 21, 128)])
@pytest.mark.parametrize("case", ["short_records", "one_window",
                                  "record_ends", "partial_batch",
                                  "whole_stacks", "native_parse",
                                  "strings"])
def test_pack_stacks_matches(case, k, m, l_out):
    """The bulk layout (window_table, then pack_stacks from one code
    buffer) equals brisk_tpu's WindowPacker.pack batch for batch, and its
    padding batches, and the empty stack asked for after them, are
    empty, at batch 8 and stack 2. ACGT strings go into the buffer
    through code_buffer."""
    B, S = 8, 2
    tp = t_windows.WindowPacker(k, m, B, l_out=l_out)
    if case == "native_parse":
        buf, offs = t_native.parse_fasta_buffer(FASTAS[1])
        recs = j_native.parse_fasta_codes(FASTAS[1])
    elif case == "strings":
        rng = np.random.default_rng(k)
        recs = ["".join(rng.choice(list("ACGTacgt"), n))
                for n in _bulk_lengths(case, tp)]
        buf, offs = t_windows.code_buffer(recs)
    else:
        lengths = _bulk_lengths(case, tp)
        rng = np.random.default_rng(len(case) + k)
        buf = rng.integers(0, 4, sum(lengths), dtype=np.uint8)
        offs = np.concatenate([[0], np.cumsum(lengths)])
        recs = [buf[a:b].copy() for a, b in zip(offs, offs[1:])]
    assert [len(r) for r in recs] == np.diff(offs).tolist()
    want = list(j_windows.WindowPacker(k, m, B, l_out=l_out).pack(iter(recs)))
    table = tp.window_table(offs[:-1], np.diff(offs))
    n_stacks = -(-len(want) // S) + 1
    stacks = list(tp.pack_stacks(buf, table, S, n_stacks))
    got = [bt for st in stacks for bt in st.batches]
    n_win = sum(int((bt.rec >= 0).sum()) for bt in want)
    assert len(table.start) == n_win
    assert len(got) == n_stacks * S and len(want) > 0
    if case == "partial_batch":
        assert n_win % B and len(want) % S
    if case == "whole_stacks":
        assert n_win % (S * B) == 0
    for i, bt in enumerate(got):
        if i < len(want):
            w = want[i]
            np.testing.assert_array_equal(bt.codes, w.codes)
            for f in ("valid_start", "valid_end", "rec", "win"):
                np.testing.assert_array_equal(getattr(bt, f), getattr(w, f),
                                              err_msg=f)
            assert (bt.n_kmers, bt.n_records) == (w.n_kmers, w.n_records)
        else:  # the stacks' padding, as pack's empty lanes
            assert not (bt.codes.any() or bt.valid_start.any()
                        or bt.valid_end.any() or bt.win.any())
            assert (bt.rec == -1).all() and bt.n_kmers == bt.n_records == 0
    for st in stacks:  # the arrays the sharded step takes
        assert st.codes.shape == (S, B, tp.l_buf)
        for f in ("codes", "valid_start", "valid_end"):
            np.testing.assert_array_equal(
                getattr(st, f), np.stack([getattr(bt, f)
                                          for bt in st.batches]))


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (63, 21, 14)])
def test_key_batch_matches(k, m, b):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (300, k), dtype=np.uint8)
    codes[:20] = 0  # poly-A ties
    jb, jc = j_keying.key_batch(codes, m, b)
    tb, tc = t_keying.key_batch(codes, m, b)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("k,b", [(31, 8), (63, 14), (21, 6)])
def test_pack_key_np_matches(k, b):
    rng = np.random.default_rng(k + b)
    for _ in range(50):
        bucket = int(rng.integers(0, 1 << (2 * b)))
        kmer = int(rng.integers(0, 1 << 62)) << max(0, 2 * k - 62)
        kmer &= (1 << (2 * k)) - 1
        mini = int(rng.integers(0, 256))
        got = t_store.pack_key_np(bucket, kmer, mini, k, b)
        want = j_store.pack_key_np(bucket, kmer, mini, k, b)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def test_entries_u64_matches():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (500, 31), dtype=np.uint8)
    _, keys = j_keying.key_batch(codes, 11, 8)
    counts = rng.integers(0, 7, 500).astype(np.uint32)
    jst = j_store.IndexState(jnp.asarray(keys), jnp.asarray(counts),
                             jnp.int32(500), jnp.int32(500))
    tst = t_store.IndexState(_u32.from_np(keys, "cpu"),
                             torch.from_numpy(counts.astype(np.int64)),
                             500, 500)
    want = j_readout.entries_u64(jst, JParameters(31, 11, 8))
    got = t_readout.entries_u64(tst, Parameters(31, 11, 8))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", FASTAS)
def test_native_parse_matches(path):
    want = j_native.parse_fasta_codes(path)
    got = t_native.parse_fasta_codes(path)
    assert got is not None and want is not None
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the Python fallback parser yields the same chunks
    py = list(t_pyref.read_fasta_chunks(path))
    assert [len(c) for c in py] == [len(c) for c in got]


def _port_sources():
    """Every .py file of the package (not the gitignored build dir)."""
    out = []
    for root, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 15
    for mod in ("data_api.py", os.path.join("index", "payload.py"),
                os.path.join("index", "pipeline.py"),
                os.path.join("parallel", "multihost.py"),
                os.path.join("parallel", "sharded.py"),
                os.path.join("parallel", "facade.py")):
        assert os.path.join(PKG, mod) in files, mod
    for f in files + [os.path.join(os.path.dirname(PKG), "chip_smoke.py")]:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        for mod in _imported_modules(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "brisk_tpu"), (f, mod)


def test_import_loads_no_jax():
    """Importing every module of the port in a fresh interpreter leaves
    jax unloaded and builds nothing."""
    mods = ["brisk_tpu_torch." + os.path.relpath(f, PKG)[:-3].replace(
        os.sep, ".") for f in _port_sources()
        if not f.endswith("__init__.py")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'brisk_tpu' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PKG))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
