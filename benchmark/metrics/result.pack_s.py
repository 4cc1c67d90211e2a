"""Seconds a build of BwtResult.packed(), the `<obj>` bytes a library
user gets (the fused engine's words fetched from the card; the grouped
tier's host 2-bit pack), timed by the harness's span around it."""

from benchmark.measure.readers import mean_seconds


def read(w):
    return mean_seconds(w, ["pack"], where="spans")
