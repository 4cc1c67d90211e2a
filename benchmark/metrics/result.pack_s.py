"""Seconds a build of BwtResult.packed(), the `<obj>` bytes a library
user gets (on every tier the packed words put in the file's u64 order
on their device, fetched once and copied out by tobytes), timed by the
harness's span around it."""

from benchmark.measure.readers import mean_seconds


def read(w):
    return mean_seconds(w, ["pack"], where="spans")
