"""Named host spans of the program's steps, on the profiler's clock.

    with spans.span("parse"): ...     a step (a leaf)
    with spans.call("insert_file"): ...  a public entry point

Spans are on in a thread on which torch.profiler runs
(torch.autograd._profiler_enabled()), and inside `recording()`. Off,
`span` and `call` return one shared null context: one check a call.
On, each appends Span(name, parent, thread, start_ns, end_ns, kind) to
an in-memory list, stamped with time.time_ns(), the clock that kineto
stamps CPU ranges with. `parent` is the "/"-joined names of the spans
open around it ("query_file/insert_file"). A leaf under the profiler
also opens the range "brisk.<name>" (kind "range"), so that it lands in
the trace beside the device's events; elsewhere it is kind "leaf". The
range is a function-scope one (torch._C._profiler._RecordFunctionFast):
a user-scope record_function would also put a gpu_user_annotation on
the device's timeline, over the gaps between its kernels. A call is
kind "call" and never a profiler range: it only gives its leaves their
parent path.

A thread that the program starts takes the state of the thread that
starts it: `ctx = context()` there, `adopt(ctx)` first thing in the new
thread. Its leaves are kept in the list but are no profiler ranges (the
profiler does not see that thread).

`records()` / `clear()` read and empty the list, which holds at most CAP
spans (`dropped()` counts the rest). `self_ns` gives each span's own
time: its length less what its direct children on its thread cover.
"""

import bisect
import contextlib
import threading
import time
from typing import NamedTuple

import torch

CAP = 1 << 16
PREFIX = "brisk."

_NULL = contextlib.nullcontext()
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_local = threading.local()
_records = []
_dropped = [0]


class Span(NamedTuple):
    name: str
    parent: str     # "/"-joined names of the spans open around it
    # the OS thread id: threading.get_ident()'s values are reused as soon
    # as a thread exits, so two short-lived threads could read as one
    thread: int     # threading.get_native_id() of the thread it ran on
    start_ns: int   # time.time_ns()
    end_ns: int
    kind: str       # "call", "range" (also a profiler range) or "leaf"


class _Open:
    __slots__ = ("name", "kind", "parent", "t0", "rf")

    def __init__(self, name: str, kind: str):
        self.name, self.kind = name, kind

    def __enter__(self):
        path = getattr(_local, "path", ())
        self.parent = path
        _local.path = path + (self.name,)
        self.rf = None
        self.t0 = time.time_ns()
        if (self.kind != "call" and _RANGE is not None
                and torch.autograd._profiler_enabled()):
            self.kind = "range"
            self.rf = _RANGE(PREFIX + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.time_ns()
        _local.path = self.parent
        if len(_records) < CAP:
            _records.append(Span(self.name, "/".join(self.parent),
                                 threading.get_native_id(), self.t0, t1,
                                 self.kind))
        else:
            _dropped[0] += 1
        return False


def _on() -> bool:
    return (getattr(_local, "on", 0) > 0
            or torch.autograd._profiler_enabled())


def span(name: str):
    """A step of the program: recorded when on, else a null context."""
    return _Open(name, "leaf") if _on() else _NULL


def call(name: str):
    """A public entry point: recorded when on (never a profiler range),
    so that the leaves inside it carry it in their parent path."""
    return _Open(name, "call") if _on() else _NULL


def iterate(name: str, iterable):
    """The items of `iterable`, each next() inside span(name), the one
    that finds it exhausted too."""
    it = iter(iterable)
    while True:
        with span(name):
            item = next(it, _NULL)
        if item is _NULL:
            return
        yield item


@contextlib.contextmanager
def recording():
    """Spans on in this thread (and the threads it starts) without the
    profiler, for tools that read the list."""
    _local.on = getattr(_local, "on", 0) + 1
    try:
        yield
    finally:
        _local.on -= 1


def context() -> tuple:
    """This thread's on/off state and span path, for adopt()."""
    return _on(), getattr(_local, "path", ())


def adopt(ctx: tuple) -> None:
    """Take a context() from the thread that started this one."""
    on, path = ctx
    _local.on = 1 if on else 0
    _local.path = path


def records() -> list:
    return list(_records)


def dropped() -> int:
    return _dropped[0]


def clear() -> None:
    _records.clear()
    _dropped[0] = 0


def self_ns(recs) -> list:
    """Each span's own ns: its length less its direct children's, a
    child being a span of the same thread whose parent path is the
    span's path and which starts inside it."""
    own = [r.end_ns - r.start_ns for r in recs]
    by_path = {}
    for i, r in enumerate(recs):
        path = f"{r.parent}/{r.name}" if r.parent else r.name
        by_path.setdefault((r.thread, path), []).append(i)
    starts = {}
    for key, idx in by_path.items():
        idx.sort(key=lambda i: recs[i].start_ns)
        starts[key] = [recs[i].start_ns for i in idx]
    for r in recs:
        key = (r.thread, r.parent)
        if not r.parent or key not in by_path:
            continue
        j = bisect.bisect_right(starts[key], r.start_ns) - 1
        if j >= 0:
            p = by_path[key][j]
            if r.end_ns <= recs[p].end_ns:
                own[p] -= r.end_ns - r.start_ns
    return own
