"""Seconds a build of the fused engine's suffix ranking of the SP string
(engine._suffix_ranks: prefix tripling, one wait a round, so the rank
loop's device time and its syncs): the program's span debwt.finish.rank."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.finish.rank")
