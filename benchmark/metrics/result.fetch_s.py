"""Seconds a build of BwtResult.packed()'s fetch of the packed words from
the card: the program's span debwt.pack.wait."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.pack.wait")
