"""query_enum_ms: the sharded query's enumeration, ms: the own time of
the program's `query.enumerate` spans under query_file (the parse and
batching of the query reads, their enumeration on the card and the
packing of their keys). None where the query has no such span."""

from benchmark import program_spans


def read(record):
    spans = program_spans.job(record)
    if spans is None:
        return None
    own = [s["own_ms"] for s in spans if s["name"] == "query.enumerate"
           and s["kind"] != "call" and s["parent"] == "query_file"]
    return sum(own) if own else None
