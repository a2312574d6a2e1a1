"""join_merge_ms: the query join's chunks (padding, sort, scan and the
read of their total), ms: the own time of the program's `join.merge`
spans under query_file."""

from benchmark import program_spans


def read(record):
    return program_spans.own_ms(
        record, "join.merge",
        lambda p: program_spans.top(p) == "query_file")
