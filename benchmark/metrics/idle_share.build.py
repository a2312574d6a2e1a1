"""idle_share.build: 1 - device busy / wall over the traced job's build
(Brisk(...), insert_file, finalize), %."""

from benchmark import tracing


def read(record):
    wall = tracing.span_ms(record, "build")
    busy = tracing.busy_ms(record, "build")
    if not wall or busy is None:
        return None
    return 100.0 * (1.0 - busy / wall)
