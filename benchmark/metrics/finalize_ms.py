"""finalize_ms: the traced job's `finalize` span (host clock, closed by a
device synchronize), ms."""

from benchmark import tracing


def read(record):
    return tracing.span_ms(record, "finalize")
