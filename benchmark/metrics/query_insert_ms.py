"""query_insert_ms: the query's shadow insert, ms: the length of the
program's `insert_file` call span under query_file (the parse, packing
and flushes of the query reads into a temporary arena)."""

from benchmark import program_spans


def read(record):
    spans = program_spans.job(record)
    if spans is None:
        return None
    return sum(((s["end"] - s["start"]) / 1e3 for s in spans
                if s["kind"] == "call" and s["name"] == "insert_file"
                and s["parent"] == "query_file"), 0.0)
