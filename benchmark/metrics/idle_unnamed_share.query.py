"""idle_unnamed_share.query: the device-idle time inside the traced job's
query_file that no leaf span of the program covers (on any thread), over
that idle time, %."""

from benchmark import program_spans


def read(record):
    return program_spans.idle_unnamed_share(record, "query")
