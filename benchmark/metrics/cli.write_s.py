"""Seconds a job of the CLI's writer (debwt_tpu_torch.io.write_bwt, with
BwtResult.packed()), timed by the harness's span around it."""

from benchmark.measure.readers import mean_seconds


def read(w):
    return mean_seconds(w, ["write"], where="spans")
