"""Seconds a job of the CLI's base encoding (for FASTA, the native scan of
each chunk's whole lines straight into the collection, and the random
policy's draws; for FASTQ, io.fasta._encode on each chunk's kept
bytes): the program's spans debwt.ingest.encode."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.ingest.encode")
