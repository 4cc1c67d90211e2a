"""Seconds a build of BwtResult.packed() on the grouped tier's result
(the words' fetch and the `<obj>` bytes' assembly): the program's own
span debwt.pack."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.pack")
