"""alloc_ms: the build's arena allocations and reallocations, ms: the
own time of the program's `alloc` spans outside query_file (the
constructor's arena, the presize, every growth)."""

from benchmark import program_spans


def read(record):
    return program_spans.own_ms(
        record, "alloc",
        lambda p: program_spans.top(p) != "query_file")
