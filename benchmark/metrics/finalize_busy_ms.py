"""finalize_busy_ms: device busy time inside the traced job's `finalize`
span, ms."""

from benchmark import tracing


def read(record):
    return tracing.busy_ms(record, "finalize")
