"""Seconds a build of the fused engine's SP-event sort (engine.stage_finish:
the node and special-branch events sorted into the SP string, and the wait
for its length that ends it): the program's span debwt.finish.sp."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.finish.sp")
