"""Seconds a job of the CLI's FASTA parse (io.fasta._stream_reads: the
line table, span mask and CR count of each chunk): the program's spans
debwt.ingest.parse."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.ingest.parse")
