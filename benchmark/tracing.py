"""The benchmark's spans, the traced job's record and the arithmetic that
the per-layer readers share.

A span is the benchmark's own: a host-clock interval around a public
call of the program, closed by a device synchronize, and under the
profiler also a `torch.profiler.record_function` range named
"bench.<span>". Device activity (kernels, copies, sets) comes from the
profiler's CUPTI trace, on the same clock as the ranges.

`union_ms` and the idle arithmetic are frozen from
brisk_tpu_torch/trace_insert.py (commit 44e47b2).
"""

import contextlib
import time

import torch

PREFIX = "bench."


class Spans:
    """Times named spans on the host clock, each closed by `sync`; with
    `annotate`, also marks each as a profiler range."""

    def __init__(self, sync, annotate: bool = False):
        self.sync = sync
        self.annotate = annotate
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(PREFIX + name)
              if self.annotate else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
            self.sync()
        self.seconds[name] = time.perf_counter() - t0


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_ms(intervals) -> float:
    """Total length (ms) of the union of (start, end) intervals in us."""
    return sum(e - s for s, e in merged(intervals)) / 1e3


def clipped(events, lo: float, hi: float) -> list:
    """(name, start, end) events cut to [lo, hi]; those outside dropped."""
    return [(n, max(s, lo), min(e, hi)) for n, s, e in events
            if e > lo and s < hi]


def span_ms(record: dict, span: str):
    """The span's length in the traced job (ms), or None."""
    se = record["spans"].get(span)
    return None if se is None else (se[1] - se[0]) / 1e3


def busy_ms(record: dict, span: str):
    """Union of device activity inside the span (ms), or None if the span
    or its device activity is missing."""
    se = record["spans"].get(span)
    if se is None:
        return None
    ev = clipped(record["device"], *se)
    if not ev:
        return None
    return union_ms((s, e) for _, s, e in ev)


def kernel_ms(record: dict, span: str, match) -> tuple:
    """(launches, summed ms) of the device events inside the span whose
    name satisfies `match`."""
    se = record["spans"].get(span)
    if se is None:
        return 0, 0.0
    ev = [(n, s, e) for n, s, e in clipped(record["device"], *se)
          if match(n)]
    return len(ev), sum(e - s for _, s, e in ev) / 1e3


def profiled(job, dev: torch.device) -> tuple:
    """Run job(spans) under torch.profiler (CPU and CUDA) and return
    (its result, the trace record): spans, device events, CPU ops,
    busy_s, window_s and the breakdown."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    spans = Spans(sync, annotate=True)
    with profile(activities=acts) as prof:
        with spans("job"):
            res = job(spans)
    events = prof.events()
    rec = dict(spans={}, device=[], cpu=[])
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(PREFIX):
                rec["device"].append((e.name, s, t))
        elif e.name.startswith(PREFIX):
            rec["spans"][e.name[len(PREFIX):]] = (s, t)
        else:
            rec["cpu"].append((e.name, s, t))
    lo, hi = rec["spans"]["job"]
    ev = clipped(rec["device"], lo, hi)
    rec["busy_s"] = union_ms((s, e) for _, s, e in ev) / 1e3
    rec["window_s"] = (hi - lo) / 1e6
    rec["breakdown"] = breakdown(rec, ev, lo, hi)
    return res, rec


def breakdown(rec: dict, ev: list, lo: float, hi: float,
              top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the span and the host operation that overlaps each
    most ("host" where no profiled operation runs)."""
    by_name = {}
    for n, s, e in ev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged((s, e) for _, s, e in ev)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    inner = [(n, se) for n, se in rec["spans"].items() if n != "job"]
    out = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        where = [n for n, (s, e) in sorted(inner, key=lambda x: x[1][1] -
                                          x[1][0]) if s <= mid <= e]
        best, best_len = "host", 0.0
        for n, s, e in rec["cpu"]:
            ov = min(e, g1) - max(s, g0)
            if ov > best_len:
                best, best_len = n, ov
        label = (where[0] + ": " if where else "") + best
        out.append([label[:120], (g1 - g0) / 1e6])
    return dict(device_ops=[[n[:120], t] for n, t in ops], idle_gaps=out)


def device_info(dev: torch.device, count: int, peak: int) -> dict:
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=count, memory_peak_bytes=int(peak))
    return dict(platform="cpu", kind="cpu", count=count,
                memory_peak_bytes=0)
