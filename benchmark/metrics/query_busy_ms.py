"""query_busy_ms: device busy time inside the traced job's `query_file`
span (the shadow insert of the query reads and the join), ms."""

from benchmark import tracing


def read(record):
    return tracing.busy_ms(record, "query")
