"""Percent of the traced window in which no operation ran on the device:
one less the union of device activity over the window's wall time."""

from benchmark.measure.readers import idle_pct


def read(w):
    return idle_pct(w)
