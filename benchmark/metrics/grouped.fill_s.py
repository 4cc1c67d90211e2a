"""Seconds a build of the grouped tier's last stage on the card: the
groups' fills and the blue entries into the BWT, the sidecars and the
packed words: the program's spans debwt.grouped.fill."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.grouped.fill")
