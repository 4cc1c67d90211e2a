"""Seconds a build in which the host waits on the device inside api.build
(the device on the host's critical path): the program's *.wait spans
within debwt.build."""

from benchmark.measure.program import waits


def read(w):
    got = waits(w, ["debwt.build"])
    return None if got is None else got[1]
