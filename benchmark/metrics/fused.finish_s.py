"""Seconds a build of the fused engine's finish stage (engine.stage_finish:
SP sort, suffix ranks, blue sort, pack): timings["stage_finish (+sync)"]."""

from benchmark.measure.readers import mean_seconds


def read(w):
    return mean_seconds(w, ["stage_finish (+sync)"])
