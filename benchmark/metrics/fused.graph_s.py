"""Seconds a build of the fused engine's graph stage (engine.stage_graph:
h2d, kernel 1, the graph sort, kernel 2 x4, then the sync):
timings["stage_graph (+h2d, sync)"]."""

from benchmark.measure.readers import mean_seconds


def read(w):
    return mean_seconds(w, ["stage_graph (+h2d, sync)"])
