"""parse_ranges: the byte ranges the native parse of the traced job's
build ran in, a count of the program's `parse.range` spans under the
build's insert_file (one a range, each on a thread of its own). 1 means
the parallel parse did not engage; a program without the span reads
nothing."""

from benchmark import program_spans


def read(record):
    spans = program_spans.job(record)
    if spans is None:
        return None
    n = sum(1 for s in spans if s["name"] == "parse.range"
            and program_spans.top(s["parent"]) == "insert_file")
    return n or None
