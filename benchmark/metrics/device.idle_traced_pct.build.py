"""Percent of the traced window's device-idle time that the program's
spans put down to a named stage: the innermost debwt. span open on the
host then is not a root (debwt.build, debwt.pack, debwt.cli)."""

from benchmark.measure.program import idle_traced_pct


def read(w):
    return idle_traced_pct(w)
