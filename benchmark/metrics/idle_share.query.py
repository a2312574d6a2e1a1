"""idle_share.query: 1 - device busy / wall over the traced job's
`query_file` span, %."""

from benchmark import tracing


def read(record):
    wall = tracing.span_ms(record, "query")
    busy = tracing.busy_ms(record, "query")
    if not wall or busy is None:
        return None
    return 100.0 * (1.0 - busy / wall)
