"""The insert programs as one CUDA graph replay a flush on the card: the
port of what `jax.jit(..., donate_argnums=(0,))` does for brisk_tpu's
insert_flat_sklnative, insert_stream_sklnative, insert_windows_payload
and sharded_insert_windows_sklonly (each flush one compiled program,
dispatched once).

A FlushGraph captures one program's pure body (pipeline.flat_flush_body,
pipeline.stream_flush_body, pipeline.payload_flush_body or
sharded.sharded_flush_body: every kernel and torch op of the flush but
the state's appends) at one geometry on one card. The state (an arena,
a payload log, the shards' arenas) stays out of the graph, so one graph
serves every index of that geometry (a query_file shadow too) and a
state grown by ensure_room, payload.ensure_room or sharded_skl_grow
needs no new capture. A flush through it is

    1. the inputs copied into the graph's static input buffer;
    2. one replay;
    3. the program's append from the graph's static output blocks,
       ordered after the replay on the same stream:
       pipeline.append_blocks (S x append_n), payload.append_masked (two
       slice copies at the host's n_used) or sharded.append_blocks (S
       scatters at each shard's n_rows);
    4. one clone of the small outputs (flags or certificates, end states,
       counts, chain or carry), which the next replay overwrites while
       Brisk._pending still holds up to max(4, 256 MiB / chunk bytes)
       flushes.

Capture follows PyTorch's recipe: the body runs once eagerly on a side
stream (every library loads, every kernel and CUB temp size is known),
then once under torch.cuda.graph with the graph's own memory pool.
kernels.LAUNCHES counts wrapper calls; a replay calls none, so the
capture's count is taken back out and added again on every replay: the
counts stay kernel launches on the card.

insert_flat, insert_stream, insert_payload and insert_sharded take the
eager programs' arguments and return their tuples: on CUDA tensors
through the cached graph of the call's key (device, program, static
arguments, input shapes and dtypes; captured at the key's first call),
on CPU tensors the eager programs. A sharded step's graph holds a
one-process mesh only: a mesh of several processes exchanges rows and
counts through torch.distributed collectives, which this runner does not
capture (NCCL across cards is untested), and insert_sharded refuses it
(ShardedBrisk runs that mesh's eager program).
A failed capture or replay raises; nothing falls back to the eager loop
on the card.
"""

import time
from typing import NamedTuple

import torch

from brisk_tpu_torch import kernels, spans
from brisk_tpu_torch.index import payload, pipeline
from brisk_tpu_torch.ops.minimizer import MinimizerState
from brisk_tpu_torch.parallel import multihost, sharded

_ALIGN = 16  # byte alignment of each tensor packed into a flat buffer
_GRAPHS = {}  # key -> FlushGraph


class _Packed(NamedTuple):
    """Tensors of given shapes and dtypes laid out in one uint8 buffer."""
    specs: tuple    # ((shape, dtype), ...)
    offsets: tuple  # byte offset of each
    nbytes: int

    @classmethod
    def of(cls, specs) -> "_Packed":
        offsets, at = [], 0
        for shape, dtype in specs:
            offsets.append(at)
            n = dtype.itemsize * torch.Size(shape).numel()
            at += -(-n // _ALIGN) * _ALIGN
        return cls(tuple(specs), tuple(offsets), at)

    def views(self, buf: torch.Tensor) -> list:
        """Typed views of `buf` (uint8, nbytes) in spec order."""
        out = []
        for (shape, dtype), off in zip(self.specs, self.offsets):
            n = dtype.itemsize * torch.Size(shape).numel()
            out.append(buf[off:off + n].view(dtype).view(shape))
        return out


def _spec(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype


# Each program: its body, its inputs as a flat list of tensors (the
# carry's leaves first) and back, the body's outputs split into (the
# arguments of its append after the state, carry' leaves, other small
# outputs), the append, and the split back into the eager program's
# tuple. Flat, payload and sharded flushes carry the window chain
# (_chained_*: the chain last among the program's tensor arguments).
def _chained_leaves(*args):
    *tensors, chain = args
    return [*chain[0], chain[1], *tensors]


def _chained_inputs(leaves):
    return (*leaves[8:], (MinimizerState(*leaves[:7]), leaves[7]))


def _chain_leaves(chain):
    return [*chain[0], chain[1]]


def _chain_of(carry):
    return MinimizerState(*carry[:7]), carry[7]


def _flat_split(out):
    blocks, n_live, flags, ends, n_sk, n_km, chain = out
    return (blocks, n_live), _chain_leaves(chain), [flags, *ends, n_sk,
                                                    n_km]


def _flat_result(skl, carry, small):
    flags, ends, (n_sk, n_km) = small[0], small[1:8], small[8:]
    return (skl, n_sk, n_km, flags, MinimizerState(*ends),
            skl.n_rows.clone(), _chain_of(carry))


def _stream_leaves(codes, fresh, valid_end, carry):
    return [*carry, codes, fresh, valid_end]


def _stream_inputs(leaves):
    return leaves[7], leaves[8], leaves[9], MinimizerState(*leaves[:7])


def _stream_split(out):
    blocks, n_live, n_sk, n_km, carry = out
    return (blocks, n_live), list(carry), [n_sk, n_km]


def _stream_result(skl, carry, small):
    n_sk, n_km = small
    return skl, n_sk, n_km, MinimizerState(*carry), skl.n_rows.clone()


def _payload_split(out):
    keys, lanes, n_km, cert, ends, chain = out
    return (keys, lanes), _chain_leaves(chain), [n_km, cert, *ends]


def _payload_result(state, carry, small):
    n_km, cert, ends = small[0], small[1], small[2:]
    return state, n_km, cert, MinimizerState(*ends), _chain_of(carry)


def _sharded_body(codes, valid_start, valid_end, chain, k, m, b, n_shards,
                  n_local, row_cap, skl_route_cap):
    """sharded.sharded_flush_body on the one-process mesh of n_shards
    shards on the inputs' device (the only mesh a graph can hold)."""
    if n_local != n_shards:
        raise ValueError("flush_graph: a sharded step of several "
                         "processes cannot be captured")
    return sharded.sharded_flush_body(
        codes, valid_start, valid_end, chain, k, m, b,
        multihost.Mesh(n_shards, codes.device), row_cap, skl_route_cap)


def _sharded_split(out):
    blocks, n_live, n_sk, n_km, n_sp, cert, ends, ovf, chain = out
    return ((blocks, n_live), _chain_leaves(chain),
            [n_sk, n_km, n_sp, cert, *ends, ovf])


def _sharded_result(skl, carry, small):
    n_sk, n_km, n_sp, cert, ends, ovf = (*small[:4], small[4:11],
                                         small[11])
    return (skl, n_sk, n_km, n_sp, cert, MinimizerState(*ends), ovf,
            _chain_of(carry))


class _Program(NamedTuple):
    body: object
    leaves: object
    inputs: object
    split: object
    append: object  # (state, *blocks) -> state', outside the graph
    result: object
    n_carry: int  # carry leaves at the head of the inputs


PROGRAMS = {
    "flat": _Program(pipeline.flat_flush_body, _chained_leaves,
                     _chained_inputs, _flat_split, pipeline.append_blocks,
                     _flat_result, 8),
    "stream": _Program(pipeline.stream_flush_body, _stream_leaves,
                       _stream_inputs, _stream_split,
                       pipeline.append_blocks, _stream_result, 7),
    "payload": _Program(pipeline.payload_flush_body, _chained_leaves,
                        _chained_inputs, _payload_split,
                        payload.append_masked, _payload_result, 8),
    "sharded": _Program(_sharded_body, _chained_leaves, _chained_inputs,
                        _sharded_split, sharded.append_blocks,
                        _sharded_result, 8),
}


class FlushGraph:
    """One insert program's body captured at one geometry on one card.

    program: "flat" (pipeline.flat_flush_body, static (k, m, b, row_cap,
    l_buf, useful)), "stream" (pipeline.stream_flush_body, static (k, m,
    b, row_cap)), "payload" (pipeline.payload_flush_body, static (k, m,
    b, width)) or "sharded" (sharded.sharded_flush_body, static (k, m,
    b, n_shards, n_local, row_cap, skl_route_cap)); example: the first
    flush's input tensors (the program's arguments before the static
    ones), which fix the shapes and dtypes. Raises on a CPU device and
    when the capture fails."""

    def __init__(self, program: str, device, static: tuple, example: tuple):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"FlushGraph: CUDA graphs need a CUDA device, "
                             f"got {device}")
        t0 = time.perf_counter()
        self.program = PROGRAMS[program]
        self.device = device
        self.replays = 0
        leaves = self.program.leaves(*example)
        for t in leaves:
            if t.device != device:
                raise ValueError(f"FlushGraph: input on {t.device}, "
                                 f"expected {device}")
        self._in = _Packed.of([_spec(t) for t in leaves])
        self._in_buf = torch.empty(self._in.nbytes, dtype=torch.uint8,
                                   device=device)
        self._in_views = self._in.views(self._in_buf)
        nc = self.program.n_carry
        self._carry_in = self._in_buf[:self._in.offsets[nc]]
        self._last_carry = None  # (carry leaves returned last, their bytes)
        for s, t in zip(self._in_views, leaves):
            s.copy_(t)
        args = self.program.inputs(self._in_views) + static

        # warm-up: every kernel library loaded, every temp size known
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.program.body(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_stats(device).get(
            "reserved_bytes.all.current", 0)

        self.graph = torch.cuda.CUDAGraph()
        before = dict(kernels.LAUNCHES)
        # thread_local: Brisk's producer thread stages the next flush's
        # inputs while the consumer thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            blocks, carry, small = self.program.split(
                self.program.body(*args))
            if [_spec(t) for t in carry] != list(self._in.specs[:nc]):
                raise RuntimeError("FlushGraph: the body's carry out does "
                                   "not match its carry in")
            self._out = _Packed.of([_spec(t) for t in carry + small])
            self._out_buf = torch.empty(self._out.nbytes, dtype=torch.uint8,
                                        device=device)
            for s, t in zip(self._out.views(self._out_buf), carry + small):
                s.copy_(t)
        self.captured_launches = kernels.launch_delta(before,
                                                      kernels.LAUNCHES)
        kernels.add_launches(self.captured_launches, -1)
        self.blocks = blocks
        self.pool_bytes = torch.cuda.memory_stats(device).get(
            "reserved_bytes.all.current", 0) - reserved
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, skl, *inputs):
        """One flush: the eager program's tuple for (skl, *inputs)."""
        leaves = self.program.leaves(*inputs)
        nc = self.program.n_carry
        last = self._last_carry
        if last is not None and all(a is b for a, b in
                                    zip(leaves[:nc], last[0])):
            self._carry_in.copy_(last[1])  # the last flush's carry out
            first = nc
        else:
            first = 0
        for s, t in zip(self._in_views[first:], leaves[first:]):
            if t.device != self.device:
                raise ValueError(f"FlushGraph: input on {t.device}, "
                                 f"expected {self.device}")
            s.copy_(t)
        self.graph.replay()
        self.replays += 1
        kernels.add_launches(self.captured_launches)
        skl = self.program.append(skl, *self.blocks)
        out = self._out_buf.clone()
        views = self._out.views(out)
        carry = views[:nc]
        self._last_carry = (carry, out[:self._carry_in.shape[0]])
        return self.program.result(skl, carry, views[nc:])


def runner(program: str, device, static: tuple, inputs: tuple) -> FlushGraph:
    """The cached FlushGraph of (device, program, static arguments, input
    shapes and dtypes), captured from `inputs` at the key's first call."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, program, static,
           tuple(_spec(t) for t in PROGRAMS[program].leaves(*inputs)))
    if key not in _GRAPHS:
        with spans.span("capture"):  # the warm-up and the capture
            _GRAPHS[key] = FlushGraph(program, device, static, inputs)
    return _GRAPHS[key]


def graphs() -> list:
    """The cached graphs: [dict(program, static, replays, pool_bytes,
    captured_launches, capture_s)], in capture order; capture_s is the
    host wall of the warm-up and the capture, synchronized."""
    return [dict(program=key[1], static=key[2], replays=g.replays,
                 pool_bytes=g.pool_bytes,
                 captured_launches=sum(g.captured_launches.values()),
                 capture_s=g.capture_s)
            for key, g in _GRAPHS.items()]


def clear() -> None:
    """Drop every cached graph and its memory pool."""
    _GRAPHS.clear()


def insert_flat(skl, chunk4: torch.Tensor, valid_start: torch.Tensor,
                valid_end: torch.Tensor, chain, k: int, m: int, b: int,
                row_cap: int, l_buf: int, useful: int):
    """pipeline.insert_flat_sklnative, one graph replay a flush on the
    card (the eager program on the CPU); the same arguments and tuple."""
    if chunk4.device.type != "cuda":
        return pipeline.insert_flat_sklnative(
            skl, chunk4, valid_start, valid_end, chain, k, m, b, row_cap,
            l_buf, useful)
    inputs = (chunk4, valid_start, valid_end, chain)
    g = runner("flat", chunk4.device, (k, m, b, row_cap, l_buf, useful),
               inputs)
    return g(skl, *inputs)


def insert_stream(skl, codes: torch.Tensor, fresh: torch.Tensor,
                  valid_end: torch.Tensor, carry: MinimizerState,
                  k: int, m: int, b: int, row_cap: int):
    """pipeline.insert_stream_sklnative, one graph replay a flush on the
    card (the eager program on the CPU); the same arguments and tuple."""
    if codes.device.type != "cuda":
        return pipeline.insert_stream_sklnative(
            skl, codes, fresh, valid_end, carry, k, m, b, row_cap)
    inputs = (codes, fresh, valid_end, carry)
    g = runner("stream", codes.device, (k, m, b, row_cap), inputs)
    return g(skl, *inputs)


def insert_payload(state, codes: torch.Tensor, valid_start: torch.Tensor,
                   valid_end: torch.Tensor, pos0: torch.Tensor, chain,
                   k: int, m: int, b: int, width: int):
    """pipeline.insert_windows_payload, one graph replay a flush on the
    card (the eager program on the CPU); the same arguments and tuple."""
    if codes.device.type != "cuda":
        return pipeline.insert_windows_payload(
            state, codes, valid_start, valid_end, pos0, chain, k, m, b,
            width)
    inputs = (codes, valid_start, valid_end, pos0, chain)
    g = runner("payload", codes.device, (k, m, b, width), inputs)
    return g(state, *inputs)


def insert_sharded(skl, codes: torch.Tensor, valid_start: torch.Tensor,
                   valid_end: torch.Tensor, chain, k: int, m: int, b: int,
                   mesh: multihost.Mesh, row_cap: int, skl_route_cap: int):
    """sharded.sharded_insert_windows_sklonly, one graph replay a step on
    the card (the eager program on the CPU); the same arguments and
    tuple. Raises on a CUDA mesh of several processes (see the module
    note)."""
    if codes.device.type != "cuda":
        return sharded.sharded_insert_windows_sklonly(
            skl, codes, valid_start, valid_end, chain, k, m, b, mesh,
            row_cap, skl_route_cap)
    if mesh.group is not None:
        raise ValueError("flush_graph.insert_sharded: a mesh of several "
                         "processes runs torch.distributed collectives, "
                         "which the runner does not capture; run "
                         "sharded.sharded_insert_windows_sklonly")
    inputs = (codes, valid_start, valid_end, chain)
    g = runner("sharded", codes.device, (k, m, b, mesh.n_shards,
                                         mesh.n_local, row_cap,
                                         skl_route_cap), inputs)
    return g(skl, *inputs)
