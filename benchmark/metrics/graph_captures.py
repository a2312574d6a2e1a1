"""graph_captures: the flush graphs captured inside the traced job, a
count of the program's `capture` spans (a warm-up and a capture each).
The warm-up job captures every graph a cell uses, so a capture here is
set-up leaking into the window; 0 expected."""

from benchmark import program_spans


def read(record):
    spans = program_spans.job(record)
    if spans is None:
        return None
    return sum(1 for s in spans if s["name"] == "capture")
