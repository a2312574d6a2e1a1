"""pack_ms: the host's packing and staging of the traced job's build,
ms: the own time of the program's `pack` spans under the build's
insert_file, on any thread (at k <= 32 they run in the insert's
producer thread)."""

from benchmark import program_spans


def read(record):
    return program_spans.own_ms(
        record, "pack",
        lambda p: program_spans.top(p) == "insert_file")
