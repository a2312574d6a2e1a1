"""The insert programs split for the card's CUDA graphs, on the CPU:
pipeline.flat_flush_body and stream_flush_body plus append_blocks against
brisk_tpu's jitted insert_flat_sklnative and insert_stream_sklnative,
flush after flush with the chain or carry carried (arena columns whole,
flags, end states, counts, chain or carry, all bit for bit); the graph
runner's plumbing (inputs packed into one buffer and the small outputs
out of one, per program: flat, stream, payload and sharded) around the
same bodies; the runner refusing a CPU device; its launch bookkeeping.
The payload and sharded bodies against brisk_tpu are in
tests/test_torch_payload_graph.py and tests/test_torch_sharded.py. Inputs come from numpy and the
repository's FASTA fixtures. The runner itself (capture, replay) needs a
card: tests/test_torch_cuda.py -k graph."""

import random
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brisk_tpu.index import pipeline as j_pipe
from brisk_tpu.index import sklstore as j_skl
from brisk_tpu.io import fasta as j_fasta
from brisk_tpu.io import windows as j_win
from brisk_tpu.ops import enumerate as j_enum
from brisk_tpu.oracle import pyref
from brisk_tpu_torch import _u32, kernels
from brisk_tpu_torch.api import Brisk
from brisk_tpu_torch.index import flush_graph
from brisk_tpu_torch.index import payload as t_payload
from brisk_tpu_torch.index import pipeline as t_pipe
from brisk_tpu_torch.index import sklstore as t_skl
from brisk_tpu_torch.index import store as t_store
from brisk_tpu_torch.io import windows as t_win
from brisk_tpu_torch.ops import enumerate as t_enum
from brisk_tpu_torch.parallel import sharded as t_sharded
from brisk_tpu_torch.params import Parameters

torch.set_num_threads(2)

S = 2
K31 = (31, 11, 8)
K63 = (63, 21, 14)


def _repair_fixture(path):
    """One record whose windows need exact repairs (equal-hash minimizer
    ties across window seams) at batch 16, window 64."""
    rng = random.Random(5)

    def rs(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    rec = (rs(300) + "ACGTTGCA" * 200 + rs(300) + "AAAAAAAAAAAAC" * 80
           + rs(300))
    path.write_text(">repair\n" + rec + "\n")
    return str(path)


def _i64(x):
    return np.asarray(x).astype(np.int64)


def _assert_arenas(js, ts):
    """Both packages' arenas, every column whole (the dead tails past
    n_rows too) and n_rows."""
    assert int(ts.n_rows) == int(js.n_rows)
    for f in ("bucket", "meta", "nucs"):
        np.testing.assert_array_equal(_u32.to_np(getattr(ts, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)


def _flat_flushes(path, batch, window, n):
    """The first n packed flushes (brisk_tpu's WindowPacker.pack_flat) of
    a FASTA at a Brisk's geometry, with its row_cap and packer."""
    geo = Brisk(Parameters(*K31), batch=batch, window=window, stack=S,
                device="cpu")
    packer = j_win.WindowPacker(K31[0], K31[1], batch, l_out=geo.window)
    recs = list(pyref.read_fasta_chunks(path))
    flushes = []
    for fl in packer.pack_flat(iter(recs), S):
        flushes.append((fl.chunk4, fl.valid_start.reshape(S, batch),
                        fl.valid_end.reshape(S, batch), fl.rec))
        if len(flushes) == n:
            break
    assert len(flushes) == n
    return flushes, geo.skl_row_cap, packer


@pytest.mark.parametrize("case", ["debug_test", "repair"])
def test_flat_body_and_append_match_brisk_tpu(case, tmp_path):
    """Two flushes of k=31 through flat_flush_body + append_blocks, the
    chain carried, against brisk_tpu's jitted insert_flat_sklnative: the
    arena, flags, end states, counts and chain after every flush. The
    repair case holds lanes that fail their certificate (flags bit 0
    clear: the lanes Brisk._retire repairs)."""
    k, m, b = K31
    if case == "repair":
        path, batch, window = _repair_fixture(tmp_path / "repair.fa"), 16, 64
    else:
        path, batch, window = "data/debug_test.fa", 16, 96
    flushes, row_cap, packer = _flat_flushes(path, batch, window, 2)
    nw = t_skl.skl_dims(k, m, b)[3]
    R = batch * row_cap
    js = j_skl.empty(1 << 13, 1 << 12, nw)
    ts = t_skl.empty(1 << 13, 1 << 12, nw, "cpu")
    jch, tch = j_pipe.zero_chain(), t_pipe.zero_chain()
    failed = 0
    for chunk4, vs, ve, rec in flushes:
        jo = j_pipe.insert_flat_sklnative(
            js, jnp.asarray(chunk4), jnp.asarray(vs), jnp.asarray(ve), jch,
            k=k, m=m, b=b, row_cap=row_cap, l_buf=packer.l_buf,
            useful=packer.useful)
        n_rows0 = int(ts.n_rows)
        blocks, n_live, flags, ends, n_sk, n_km, tch = t_pipe.flat_flush_body(
            torch.from_numpy(chunk4), torch.from_numpy(vs),
            torch.from_numpy(ve), tch, k, m, b, row_cap, packer.l_buf,
            packer.useful)
        assert blocks.bucket.shape == blocks.meta.shape == (S, R)
        assert blocks.nucs.shape == (S, nw, R)
        assert blocks.bucket.dtype == torch.int32 and n_live.shape == (S,)
        ts = t_pipe.append_blocks(ts, blocks, n_live)
        js, jch = jo[0], jo[6]
        assert int(ts.n_rows) == n_rows0 + int(n_live.sum())
        _assert_arenas(js, ts)
        np.testing.assert_array_equal(flags.numpy(), np.asarray(jo[3]))
        assert int(n_sk) == int(jo[1]) and int(n_km) == int(jo[2])
        for a, c in zip(jo[4], ends):
            np.testing.assert_array_equal(c.numpy().astype(np.int64),
                                          _i64(a))
        (jend, jex), (tend, tex) = jch, tch
        assert bool(jex) == bool(tex)
        assert [int(x) for x in jend] == [int(x) for x in tend]
        lanes = rec.reshape(S, batch) >= 0
        failed += int(((flags.numpy() & 1) == 0)[lanes].sum())
    assert (failed > 0) == (case == "repair")


def _stream_flushes(n):
    """The first n stacks of k=63 streaming batches (brisk_tpu's
    BatchPacker, 4 lanes, 64 new bases a batch) of records that stream
    across batches and flushes."""
    rng = np.random.default_rng(5)
    recs = ["".join("ACGT"[c] for c in rng.integers(0, 4, length))
            for length in (700, 30, 90, 62, 63, 250, 500, 10, 140, 333, 64,
                           900)]
    packer = j_fasta.BatchPacker(K63[0], 4, 64)
    batches = list(packer.pack(iter(recs)))
    assert len(batches) >= n * S
    return [tuple(np.stack([getattr(bt, f) for bt in batches[i:i + S]])
                  for f in ("codes", "fresh", "valid_end"))
            for i in range(0, n * S, S)]


def test_stream_body_and_append_match_brisk_tpu():
    """Two flushes of k=63 through stream_flush_body + append_blocks, the
    carry carried, against brisk_tpu's jitted insert_stream_sklnative:
    the arena, counts and carry after every flush."""
    k, m, b = K63
    row_cap = 64
    nw = t_skl.skl_dims(k, m, b)[3]
    js = j_skl.empty(1 << 12, 1 << 12, nw)
    ts = t_skl.empty(1 << 12, 1 << 12, nw, "cpu")
    jc, tc = j_enum.zero_carry(4), t_enum.zero_carry(4)
    for codes, fresh, ve in _stream_flushes(2):
        jo = j_pipe.insert_stream_sklnative(
            js, jnp.asarray(codes), jnp.asarray(fresh), jnp.asarray(ve), jc,
            k=k, m=m, b=b, row_cap=row_cap)
        blocks, n_live, n_sk, n_km, tc = t_pipe.stream_flush_body(
            torch.from_numpy(codes), torch.from_numpy(fresh),
            torch.from_numpy(ve), tc, k, m, b, row_cap)
        ts = t_pipe.append_blocks(ts, blocks, n_live)
        js, jc = jo[0], jo[3]
        _assert_arenas(js, ts)
        assert int(n_sk) == int(jo[1]) and int(n_km) == int(jo[2])
        for a, c in zip(jc, tc):
            np.testing.assert_array_equal(c.numpy().astype(np.int64),
                                          _i64(a))
    assert int(ts.n_rows) > 0


class _Case(NamedTuple):
    """One program's plumbing case: the eager program and the runner's
    entry point as (state, *inputs, carry) -> the eager tuple, the
    program's name and static arguments, the input tuples of two flushes
    (before the carry), a fresh state, the first carry and the carry's
    index in the tuple."""
    eager: object
    via: object
    name: str
    static: tuple
    inputs: list
    state: object
    carry: object
    carry_at: int


def _flat_case():
    k, m, b = K31
    flushes, row_cap, packer = _flat_flushes("data/debug_test.fa", 16, 96,
                                             2)
    static = (k, m, b, row_cap, packer.l_buf, packer.useful)
    inputs = [tuple(torch.from_numpy(x) for x in fl[:3]) for fl in flushes]
    skl = t_skl.empty(1 << 13, 1 << 12, t_skl.skl_dims(k, m, b)[3], "cpu")
    return _Case(lambda st, *a: t_pipe.insert_flat_sklnative(st, *a,
                                                             *static),
                 lambda st, *a: flush_graph.insert_flat(st, *a, *static),
                 "flat", static, inputs, skl, t_pipe.zero_chain(), 6)


def _stream_case():
    k, m, b = K63
    static = (k, m, b, 64)
    inputs = [tuple(torch.from_numpy(x) for x in fl)
              for fl in _stream_flushes(2)]
    skl = t_skl.empty(1 << 12, 1 << 12, t_skl.skl_dims(k, m, b)[3], "cpu")
    return _Case(lambda st, *a: t_pipe.insert_stream_sklnative(st, *a,
                                                               *static),
                 lambda st, *a: flush_graph.insert_stream(st, *a, *static),
                 "stream", static, inputs, skl, t_enum.zero_carry(4), 3)


def _window_stacks(kmb, lanes, window, n, path="data/debug_test.fa"):
    """The first n stacks of S window batches (the port's WindowPacker)
    of a FASTA, and the packer."""
    packer = t_win.WindowPacker(kmb[0], kmb[1], lanes, l_out=window)
    batches = list(packer.pack(pyref.read_fasta_chunks(path)))
    assert len(batches) >= n * S
    return [batches[i:i + S] for i in range(0, n * S, S)], packer


def _payload_case():
    k, m, b = K31
    width = 2
    stacks, packer = _window_stacks(K31, 16, 96, 2)
    inputs = [(torch.from_numpy(np.stack([bt.codes for bt in st])
                                ).to(torch.int64),
               *(torch.from_numpy(np.stack([getattr(bt, f) for bt in st]))
                 for f in ("valid_start", "valid_end")),
               torch.from_numpy(np.stack([bt.win.astype(np.int64)
                                          * packer.useful for bt in st])))
              for st in stacks]
    static = (k, m, b, width)
    state = t_payload.empty(1 << 13, t_store.key_words(k, b), width, "cpu")
    return _Case(lambda st, *a: t_pipe.insert_windows_payload(st, *a,
                                                              *static),
                 lambda st, *a: flush_graph.insert_payload(st, *a, *static),
                 "payload", static, inputs, state, t_pipe.zero_chain(), 4)


def _sharded_case():
    k, m, b = K31
    n_shards, lanes, window, route_cap = 8, 4, 144, 2
    stacks, _ = _window_stacks(K31, n_shards * lanes, window, 2)
    inputs = [tuple(torch.from_numpy(np.stack([getattr(bt, f)
                                               for bt in st]))
                    for f in ("codes", "valid_start", "valid_end"))
              for st in stacks]
    row_cap = window // 4
    mesh = t_sharded.make_mesh(n_shards, "cpu")
    static = (k, m, b, n_shards, n_shards, row_cap, route_cap)
    skl = t_sharded.sharded_skl_empty(n_shards, 1 << 13, 1 << 12,
                                      t_skl.skl_dims(k, m, b)[3], mesh)
    tail = (k, m, b, mesh, row_cap, route_cap)
    return _Case(lambda st, *a: t_sharded.sharded_insert_windows_sklonly(
                     st, *a, *tail),
                 lambda st, *a: flush_graph.insert_sharded(st, *a, *tail),
                 "sharded", static, inputs, skl, t_pipe.zero_chain(), 7)


CASES = {"flat": _flat_case, "stream": _stream_case,
         "payload": _payload_case, "sharded": _sharded_case}


def _clone(state):
    """A state (an arena, a payload log) with its tensors copied."""
    return type(state)(*(x.clone() if isinstance(x, torch.Tensor) else x
                         for x in state))


def _same(a, c):
    """Two eager-program tuples (states, tensors, host ints, nested
    tuples) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == c.dtype and torch.equal(a, c)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(c)
        for x, y in zip(a, c):
            _same(x, y)
    else:
        assert a == c


@pytest.mark.parametrize("program", sorted(CASES))
def test_runner_plumbing_matches_the_eager_program(program):
    """The runner's host side on the CPU: each flush's inputs packed into
    one static buffer (the carry's bytes first), the body run from its
    views, the carry and small outputs packed into one buffer and cloned,
    the blocks appended by the program's append; every element of the
    eager program's tuple equal, over two flushes with the carry fed from
    the clone."""
    case = CASES[program]()
    prog = flush_graph.PROGRAMS[case.name]
    nc = prog.n_carry
    st_e, carry_e = case.state, case.carry
    st_g, carry_g = _clone(case.state), case.carry
    for args in case.inputs:
        want = case.eager(st_e, *args, carry_e)
        leaves = prog.leaves(*args, carry_g)
        packed = flush_graph._Packed.of([flush_graph._spec(t)
                                         for t in leaves])
        buf = torch.empty(packed.nbytes, dtype=torch.uint8)
        views = packed.views(buf)
        for v, t in zip(views, leaves):
            v.copy_(t)
        blocks, out_carry, small = prog.split(
            prog.body(*prog.inputs(views), *case.static))
        out = flush_graph._Packed.of([flush_graph._spec(t)
                                      for t in out_carry + small])
        assert out.specs[:nc] == packed.specs[:nc]
        assert out.offsets[nc] == packed.offsets[nc]
        obuf = torch.empty(out.nbytes, dtype=torch.uint8)
        for v, t in zip(out.views(obuf), out_carry + small):
            v.copy_(t)
        got_views = out.views(obuf.clone())
        st_g = prog.append(st_g, *blocks)
        got = prog.result(st_g, got_views[:nc], got_views[nc:])
        _same(want, got)
        st_e, carry_e = want[0], want[case.carry_at]
        carry_g = got[case.carry_at]


@pytest.mark.parametrize("program", sorted(CASES))
def test_runner_refuses_a_cpu_device_and_cpu_flushes_run_eagerly(program):
    """A FlushGraph cannot be built for the CPU; insert_flat,
    insert_stream, insert_payload and insert_sharded on CPU tensors run
    the eager program, equal to it, and capture nothing."""
    case = CASES[program]()
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        flush_graph.FlushGraph(case.name, "cpu", case.static,
                               case.inputs[0] + (case.carry,))
    want = case.eager(_clone(case.state), *case.inputs[0], case.carry)
    _same(want, case.via(case.state, *case.inputs[0], case.carry))
    assert flush_graph.graphs() == []


def test_packed_layout_holds_every_dtype():
    """_Packed lays tensors of any shape and dtype (0-dim included) in one
    byte buffer at 16-byte aligned, disjoint offsets; each view reads back
    what was written to it."""
    rng = np.random.default_rng(2)
    values = [torch.from_numpy(rng.integers(0, 255, (3, 5), dtype=np.uint8)),
              torch.from_numpy(rng.random(7) < 0.5),
              torch.tensor(-5, dtype=torch.int64),
              torch.from_numpy(rng.integers(-2**31, 2**31, (2, 3, 4),
                                            dtype=np.int32)),
              torch.tensor(True),
              torch.from_numpy(rng.integers(-2**62, 2**62, 9))]
    packed = flush_graph._Packed.of([flush_graph._spec(t) for t in values])
    assert all(off % 16 == 0 for off in packed.offsets)
    ends = [off + t.numel() * t.element_size()
            for off, t in zip(packed.offsets, values)]
    assert all(e <= nxt for e, nxt in zip(ends, packed.offsets[1:]))
    assert ends[-1] <= packed.nbytes
    buf = torch.zeros(packed.nbytes, dtype=torch.uint8)
    for v, t in zip(packed.views(buf), values):
        v.copy_(t)
    for v, t in zip(packed.views(buf.clone()), values):
        assert v.dtype == t.dtype and v.shape == t.shape
        assert torch.equal(v, t)


# kernel launches a flush of each program makes (S = 8 batches): the
# payload program builds no super-k-mer rows. The flat program's cases
# keep their ids (the replays alone).
PER_FLUSH = {name: dict({"positions": 16, "rescan": 16, "state_scan": 8,
                         "emit": 8}, **({} if name == "payload"
                                        else {"skl_rows": 8}))
             for name in ("flat", "payload", "sharded")}
BOOKKEEPING = [pytest.param(r, p, id=str(r) if p == "flat" else f"{p}-{r}")
               for p in PER_FLUSH for r in (0, 1, 7)]


@pytest.mark.parametrize("replays,program", BOOKKEEPING)
def test_launch_bookkeeping_counts_each_replay(replays, program):
    """kernels.launch_delta and add_launches as the runner uses them, with
    each program's kernels: the capture's wrapper calls (which launch
    nothing) are taken back out, and every replay adds the captured
    launches, so the counts equal an eager run of the same flushes."""
    counts = {"positions": 5, "rescan": 3, "state_scan": 2, "emit": 2,
              "skl_rows": 0, "join_scan": 1}
    eager = dict(counts)
    per_flush = PER_FLUSH[program]
    before = dict(counts)
    for name, n in per_flush.items():  # the capture's wrapper calls
        counts[name] += n
    delta = kernels.launch_delta(before, counts)
    assert delta == per_flush
    kernels.add_launches(delta, -1, counts)
    assert counts == before
    for _ in range(replays):
        kernels.add_launches(delta, counts=counts)
        kernels.add_launches(per_flush, counts=eager)
    assert counts == eager
    assert counts["join_scan"] == 1
    assert counts["skl_rows"] == (0 if program == "payload" else 8 * replays)
    assert kernels.launch_delta(counts, counts) == {}


@pytest.mark.parametrize("kmb,hint,reads", [(K31, None, (9000, 4000)),
                                            (K63, 10_000, (10_000,) * 3),
                                            (K63, 150, (150,) * 40)])
def test_warmup_captures_the_key_of_the_first_flush(kmb, hint, reads,
                                                    monkeypatch, tmp_path):
    """Brisk._zero_flush, what warmup captures on a card, has the
    program, static arguments and input shapes and dtypes of the first
    flush insert_file dispatches (so that flush replays that graph instead
    of capturing another): at k=31, and at k=63 for long records and for
    the short-read route at the record length the hint names."""
    rng = np.random.default_rng(8)
    path = tmp_path / "in.fa"
    path.write_text("".join(
        f">r{i}\n" + "".join("ACGT"[c] for c in rng.integers(0, 4, n))
        + "\n" for i, n in enumerate(reads)))
    br = Brisk(Parameters(*kmb), batch=16, window=128, stack=2,
               device="cpu")
    program, static, inputs = br._zero_flush(hint)
    want = (program, static, [flush_graph._spec(t) for t in
                              flush_graph.PROGRAMS[program].leaves(*inputs)])
    seen = []

    def recording(name, eager):
        def run(skl, a, c, d, carry, *static):
            leaves = flush_graph.PROGRAMS[name].leaves(a, c, d, carry)
            seen.append((name, static,
                         [flush_graph._spec(t) for t in leaves]))
            return eager(skl, a, c, d, carry, *static)
        return run

    monkeypatch.setattr(flush_graph, "insert_flat", recording(
        "flat", t_pipe.insert_flat_sklnative))
    monkeypatch.setattr(flush_graph, "insert_stream", recording(
        "stream", t_pipe.insert_stream_sklnative))
    br.insert_file(str(path))
    br._drain()
    assert seen and all(s == want for s in seen)
    assert br.n_emitted == sum(n - kmb[0] + 1 for n in reads)
