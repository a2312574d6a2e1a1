"""segment_finalize_ms: the mid-ingest segment finalizes of the build,
ms: the own time of the program's `finalize` spans under
insert_file/finalize (0 where the insert cuts no segment)."""

from benchmark import program_spans


def read(record):
    return program_spans.own_ms(
        record, "finalize",
        lambda p: p == "insert_file/finalize")
