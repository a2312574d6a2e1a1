"""parse_ms: the native FASTA parse of the traced job's build, ms: the
own time of the program's `parse` spans under the build's insert_file
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(record):
    return program_spans.own_ms(
        record, "parse",
        lambda p: program_spans.top(p) == "insert_file")
