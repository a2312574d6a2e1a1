"""The generators: the same seed gives the same bytes, another seed
other bytes, and every seed the same sizes."""

import hashlib
import os

import numpy as np
import pytest

from benchmark.gen import synth
from benchmark.reference import fasta


def digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def write_all(seed, d):
    g_rng, r_rng, q_rng = synth.streams(seed, 3)
    g = synth.genome(g_rng, 30000, 1000)
    synth.write_contig(os.path.join(d, "g.fa"), g)
    reads = synth.sample_reads(r_rng, g, synth.hifi_lengths(60000, 500,
                                                            1500), 0.001)
    synth.write_reads(os.path.join(d, "r.fa"), reads)
    q = synth.sample_reads(q_rng, g, np.full(50, 150), 0.002)
    synth.write_reads(os.path.join(d, "q.fa"), q, "q")
    return {n: digest(os.path.join(d, n)) for n in ("g.fa", "r.fa", "q.fa")}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345])
def test_same_seed_same_bytes(tmp_path, seed):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    assert write_all(seed, str(a)) == write_all(seed, str(b))


def test_other_seed_other_bytes(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    da, db = write_all(11, str(a)), write_all(12, str(b))
    assert all(da[n] != db[n] for n in da)


def test_sizes_do_not_depend_on_seed():
    lens = synth.hifi_lengths(4641652 * 28, 10000, 17000)
    assert abs(int(lens.sum()) - 4641652 * 28) < 13500
    assert lens.min() == 10000 and lens.max() == 17000
    for seed in (1, 2):
        g_rng, r_rng = synth.streams(seed, 2)
        g = synth.genome(g_rng, 5000)
        reads = synth.sample_reads(r_rng, g, np.array([100, 200, 300]),
                                   0.01)
        assert sorted(r.size for r in reads) == [100, 200, 300]


def test_reads_come_from_the_genome_on_both_strands():
    g_rng, r_rng = synth.streams(5, 2)
    g = synth.genome(g_rng, 20000, 10 ** 9)
    text = synth.LETTERS[g].tobytes()
    rc = synth.LETTERS[synth.revcomp(g)].tobytes()
    reads = synth.sample_reads(r_rng, g, np.full(40, 60), 0.0)
    where = [(synth.LETTERS[r].tobytes() in text,
              synth.LETTERS[r].tobytes() in rc) for r in reads]
    assert all(f or r for f, r in where)
    assert any(f for f, _ in where) and any(r for _, r in where)


def test_contig_round_trip(tmp_path):
    g_rng, = synth.streams(3, 1)
    g = synth.genome(g_rng, 1001, 100)
    p = str(tmp_path / "g.fa")
    synth.write_contig(p, g)
    codes = fasta.read_codes(p)
    assert codes[0] == fasta.BREAK and codes.size == 1002
    want = np.array([0, 1, 3, 2, fasta.BREAK], np.uint8)[g]
    assert np.array_equal(codes[1:], want)
