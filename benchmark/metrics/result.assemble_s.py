"""Seconds a build of BwtResult.packed()'s host assembly of the `<obj>`
bytes (the u32 to u64 interleave and tobytes): the program's span
debwt.pack.assemble."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.pack.assemble")
