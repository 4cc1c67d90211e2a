"""Seconds a build of the fused engine's host inputs (pipeline.stage_inputs:
the cached-buffer copy, the 2-bit pack of the text, the padding): the
program's span debwt.graph.inputs."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.graph.inputs")
