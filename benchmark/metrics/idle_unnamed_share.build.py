"""idle_unnamed_share.build: the device-idle time inside the traced job's
build that no leaf span of the program covers (on any thread), over that
idle time, %."""

from benchmark import program_spans


def read(record):
    return program_spans.idle_unnamed_share(record, "build")
