"""The two insert programs as one CUDA graph replay a flush on the card:
the port of what `jax.jit(..., donate_argnums=(0,))` does for brisk_tpu's
insert_flat_sklnative and insert_stream_sklnative (each flush one
compiled program, dispatched once).

A FlushGraph captures one program's pure body (pipeline.flat_flush_body
or pipeline.stream_flush_body: every kernel and torch op of the flush but
the arena's appends) at one geometry on one card. The arena stays out of
the graph, so one graph serves every Brisk of that geometry (a
query_file shadow too) and an arena grown by ensure_room needs no new
capture. A flush through it is

    1. the inputs copied into the graph's static input buffer;
    2. one replay;
    3. pipeline.append_blocks from the graph's static output blocks
       (S x append_n, ordered after the replay on the same stream);
    4. one clone of the small outputs (flags, end states, counts, chain
       or carry), which the next replay overwrites while Brisk._pending
       still holds up to max(4, 256 MiB / chunk bytes) flushes.

Capture follows PyTorch's recipe: the body runs once eagerly on a side
stream (every library loads, every kernel and CUB temp size is known),
then once under torch.cuda.graph with the graph's own memory pool.
kernels.LAUNCHES counts wrapper calls; a replay calls none, so the
capture's count is taken back out and added again on every replay: the
counts stay kernel launches on the card.

insert_flat and insert_stream take the eager programs' arguments and
return their tuples: on CUDA tensors through the cached graph of the
call's key (device, program, static arguments, input shapes and dtypes;
captured at the key's first call), on CPU tensors the eager programs. A
failed capture or replay raises; nothing falls back to the eager loop on
the card.
"""

from typing import NamedTuple

import torch

from brisk_tpu_torch import kernels
from brisk_tpu_torch.index import pipeline
from brisk_tpu_torch.ops.minimizer import MinimizerState

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
# carry's leaves first) and back, and the body's outputs split into
# (blocks, n_live, carry' leaves, other small outputs) and back into the
# eager program's tuple.
def _flat_leaves(chunk4, valid_start, valid_end, chain):
    return [*chain[0], chain[1], chunk4, valid_start, valid_end]


def _flat_inputs(leaves):
    return (leaves[8], leaves[9], leaves[10],
            (MinimizerState(*leaves[:7]), leaves[7]))


def _flat_split(out):
    blocks, n_live, flags, ends, n_sk, n_km, chain = out
    return blocks, n_live, [*chain[0], chain[1]], [flags, *ends, n_sk, n_km]


def _flat_result(skl, carry, small):
    flags, ends, (n_sk, n_km) = small[0], small[1:8], small[8:]
    chain = (MinimizerState(*carry[:7]), carry[7])
    return (skl, n_sk, n_km, flags, MinimizerState(*ends),
            skl.n_rows.clone(), chain)


def _stream_leaves(codes, fresh, valid_end, carry):
    return [*carry, codes, fresh, valid_end]


def _stream_inputs(leaves):
    return leaves[7], leaves[8], leaves[9], MinimizerState(*leaves[:7])


def _stream_split(out):
    blocks, n_live, n_sk, n_km, carry = out
    return blocks, n_live, list(carry), [n_sk, n_km]


def _stream_result(skl, carry, small):
    n_sk, n_km = small
    return skl, n_sk, n_km, MinimizerState(*carry), skl.n_rows.clone()


class _Program(NamedTuple):
    body: object
    leaves: object
    inputs: object
    split: object
    result: object
    n_carry: int  # carry leaves at the head of the inputs


PROGRAMS = {
    "flat": _Program(pipeline.flat_flush_body, _flat_leaves, _flat_inputs,
                     _flat_split, _flat_result, 8),
    "stream": _Program(pipeline.stream_flush_body, _stream_leaves,
                       _stream_inputs, _stream_split, _stream_result, 7),
}


class FlushGraph:
    """One insert program's body captured at one geometry on one card.

    program: "flat" (pipeline.flat_flush_body, static (k, m, b, row_cap,
    l_buf, useful)) or "stream" (pipeline.stream_flush_body, static (k,
    m, b, row_cap)); example: the first flush's input tensors (the
    program's arguments before the static ones), which fix the shapes and
    dtypes. Raises on a CPU device and when the capture fails."""

    def __init__(self, program: str, device, static: tuple, example: tuple):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"FlushGraph: CUDA graphs need a CUDA device, "
                             f"got {device}")
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
            blocks, n_live, carry, small = self.program.split(
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
        self.blocks, self.n_live = blocks, n_live
        self.pool_bytes = torch.cuda.memory_stats(device).get(
            "reserved_bytes.all.current", 0) - reserved

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
        skl = pipeline.append_blocks(skl, self.blocks, self.n_live)
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
        _GRAPHS[key] = FlushGraph(program, device, static, inputs)
    return _GRAPHS[key]


def graphs() -> list:
    """The cached graphs: [dict(program, static, replays, pool_bytes,
    captured_launches)], in capture order."""
    return [dict(program=key[1], static=key[2], replays=g.replays,
                 pool_bytes=g.pool_bytes,
                 captured_launches=sum(g.captured_launches.values()))
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
