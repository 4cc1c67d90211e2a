"""Blocking device-to-host fetches a build, in api.build and in
BwtResult.packed(): the number of the program's *.wait spans within
debwt.build and debwt.pack."""

from benchmark.measure.program import waits


def read(w):
    got = waits(w, ["debwt.build", "debwt.pack"])
    return None if got is None else got[0]
