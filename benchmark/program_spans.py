"""The program's own spans of the traced job, on the trace record's clock,
and the sums that their per-layer readers share.

The program (brisk_tpu_torch.spans) keeps a list of spans whenever
torch.profiler runs: Span(name, parent, thread, start_ns, end_ns, kind)
on time.time_ns(), the clock that kineto stamps CPU ranges with; a
"call" marks a public entry point, a "range" is a leaf that is also the
profiler range "brisk.<name>" (on the profiled thread), a "leaf" one
that is not (a thread the program started). Only the traced job runs
under the profiler, so the list holds its spans (and, in a process that
ran other profiled work first, theirs).

`job(record)` pairs the list's ranges with the record's "brisk.*" CPU
events by name and order (the last of each name: the traced job is the
last profiled work when the readers run), takes the median of the
offsets between the paired starts, and keeps the spans that start inside
the traced job, each with its interval on the record's clock (a paired
range: its own event's; the rest: mapped by the offset) and its own time
(its length less its direct children's on its thread). None where the
program keeps no spans, nothing pairs, or the offsets spread (first to
third quartile) by more than SPREAD_NS.
"""

import bisect
import statistics

from benchmark import tracing

PREFIX = "brisk."
SPREAD_NS = 500_000


def records():
    """The program's span list, or None for a program without one."""
    try:
        from brisk_tpu_torch import spans
    except ImportError:
        return None
    return spans.records()


def own_ns(recs) -> list:
    """Each span's length less its direct children's: a child is a span
    of the same thread whose parent path is the span's path and which
    starts inside it."""
    own = [r.end_ns - r.start_ns for r in recs]
    groups = {}
    for i, r in enumerate(recs):
        path = f"{r.parent}/{r.name}" if r.parent else r.name
        groups.setdefault((r.thread, path), []).append(i)
    for idx in groups.values():
        idx.sort(key=lambda i: recs[i].start_ns)
    starts = {key: [recs[i].start_ns for i in idx]
              for key, idx in groups.items()}
    for r in recs:
        key = (r.thread, r.parent)
        if key not in groups:
            continue
        j = bisect.bisect_right(starts[key], r.start_ns) - 1
        if j >= 0 and r.end_ns <= recs[groups[key][j]].end_ns:
            own[groups[key][j]] -= r.end_ns - r.start_ns
    return own


def offset_ns(recs, cpu) -> tuple:
    """(median offset in ns from the list's clock to the record's, the
    pairs {list index: (start, end) in the record's us}), or (None, {})
    when nothing pairs or the offsets spread too widely."""
    events = {}
    for n, s, e in cpu:
        if n.startswith(PREFIX):
            events.setdefault(n[len(PREFIX):], []).append((s, e))
    ranges = {}
    for i, r in enumerate(recs):
        if r.kind == "range":
            ranges.setdefault(r.name, []).append(i)
    pairs = {}
    for name, evs in events.items():
        idx = sorted(ranges.get(name, []), key=lambda i: recs[i].start_ns)
        evs = sorted(evs)
        n = min(len(idx), len(evs))
        if n:
            pairs.update(zip(idx[-n:], evs[-n:]))
    if not pairs:
        return None, {}
    # in integer ns: epoch ns lose their last 8 bits in a float
    offs = sorted(round(1e3 * se[0]) - recs[i].start_ns
                  for i, se in pairs.items())
    if len(offs) >= 4:
        q1, _, q3 = statistics.quantiles(offs, n=4)
        if q3 - q1 > SPREAD_NS:
            return None, {}
    return round(statistics.median(offs)), pairs


def job(record):
    """The traced job's spans: [dict(name, parent, kind, start, end,
    own_ms)], start and end in the record's us; None when they cannot
    be read (module note)."""
    recs = records()
    if not recs or "job" not in record.get("spans", {}):
        return None
    off, pairs = offset_ns(recs, record.get("cpu", []))
    if off is None:
        return None
    lo, hi = record["spans"]["job"]
    own = own_ns(recs)
    out = []
    for i, r in enumerate(recs):
        s, e = pairs.get(i, ((r.start_ns + off) / 1e3,
                             (r.end_ns + off) / 1e3))
        if lo <= s <= hi:
            out.append(dict(name=r.name, parent=r.parent, kind=r.kind,
                            start=s, end=e, own_ms=own[i] / 1e6))
    return out


def top(parent: str) -> str:
    """The outermost entry point of a parent path."""
    return parent.split("/", 1)[0]


def own_ms(record, name: str, where) -> float:
    """Summed own ms of the job's leaves `name` whose parent path
    satisfies where(parent); None when the spans cannot be read."""
    spans = job(record)
    if spans is None:
        return None
    return sum((s["own_ms"] for s in spans if s["name"] == name
                and s["kind"] != "call" and where(s["parent"])), 0.0)


def idle_unnamed_share(record, span: str):
    """The device-idle time inside the benchmark's span that no leaf span
    of any thread covers, over that idle time, %. None without device
    activity in the span or without the program's spans."""
    se = record["spans"].get(span)
    spans = job(record)
    if se is None or spans is None:
        return None
    lo, hi = se
    ev = tracing.clipped(record["device"], lo, hi)
    if not ev:
        return None
    edges = [lo] + [x for iv in tracing.merged((s, e) for _, s, e in ev)
                    for x in iv] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle_us = sum(e - s for s, e in idle)
    if not idle_us:
        return 0.0
    named = tracing.merged((max(s["start"], lo), min(s["end"], hi))
                           for s in spans if s["kind"] != "call"
                           and s["end"] > lo and s["start"] < hi)
    covered, j = 0.0, 0
    for s, e in idle:
        while j < len(named) and named[j][1] <= s:
            j += 1
        k = j
        while k < len(named) and named[k][0] < e:
            covered += min(e, named[k][1]) - max(s, named[k][0])
            k += 1
    return 100.0 * (idle_us - covered) / idle_us
