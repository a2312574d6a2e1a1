"""join_expand_ms: the query join's expansions of the index and of the
query arena, ms: the own time of the program's `join.expand` spans under
query_file."""

from benchmark import program_spans


def read(record):
    return program_spans.own_ms(
        record, "join.expand",
        lambda p: program_spans.top(p) == "query_file")
