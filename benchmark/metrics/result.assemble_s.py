"""Seconds a build of BwtResult.packed()'s host assembly of the `<obj>`
bytes (one tobytes of the fetched words, already in the file's u64
order): the program's span debwt.pack.assemble."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.pack.assemble")
