"""Seconds a job of the CLI's ingest (debwt_tpu_torch.io.read_collection,
as cli._run calls it), timed by the harness's span around it."""

from benchmark.measure.readers import mean_seconds


def read(w):
    return mean_seconds(w, ["ingest"], where="spans")
