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
