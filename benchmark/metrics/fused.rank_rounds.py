"""Rounds a build of the fused engine's suffix ranking of the SP string:
the program's *.wait spans within debwt.finish.rank, one a round."""

from benchmark.measure.program import waits


def read(w):
    got = waits(w, ["debwt.finish.rank"])
    return None if got is None else got[0]
