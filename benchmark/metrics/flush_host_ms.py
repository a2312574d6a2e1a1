"""flush_host_ms: the host's time in the build's flushes, ms: the own
time of the program's `flush` spans (one graph replay, the appends and
the output clone each) under the build's insert_file."""

from benchmark import program_spans


def read(record):
    return program_spans.own_ms(
        record, "flush",
        lambda p: program_spans.top(p) == "insert_file")
