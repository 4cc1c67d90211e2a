"""Seconds a job of the CLI's file reads (io.fasta._stream_reads: each
chunk read and joined to the carry): the program's spans
debwt.ingest.read."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.ingest.read")
