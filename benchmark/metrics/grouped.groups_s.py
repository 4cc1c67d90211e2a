"""Seconds a build of the grouped tier's group passes (the plan, then a
group at a time: selection, classification, the event and blue rows'
fetch): the program's span debwt.grouped.groups."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.grouped.groups")
