"""Seconds a build of the special module (special.build_special, host
NumPy): the program's timings["special module (host)"]."""

from benchmark.measure.readers import mean_seconds


def read(w):
    return mean_seconds(w, ["special module (host)"])
