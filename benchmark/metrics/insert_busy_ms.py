"""insert_busy_ms: device busy time inside the traced job's `insert_file`
span: the union of its kernels, copies and sets, ms."""

from benchmark import tracing


def read(record):
    return tracing.busy_ms(record, "insert")
