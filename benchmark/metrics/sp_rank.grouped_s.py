"""Seconds a build of the grouped tier's SP string and its suffix ranks
(oocore.sp_string, oocore.sp_ranks): the program's span
debwt.grouped.sp."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.grouped.sp")
