"""readback_ms: the build's device-to-host reads that block the host,
ms: the own time of the program's `readback` spans under the build's
insert_file and finalize."""

from benchmark import program_spans


def read(record):
    return program_spans.own_ms(
        record, "readback",
        lambda p: program_spans.top(p) in ("insert_file", "finalize"))
