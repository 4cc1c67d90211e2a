"""Seconds a job of the CLI's file reads (for FASTA, io.read_collection's
native pass: each chunk's carry moved to the buffer's front and the
readinto; for FASTQ, io.fasta._stream_reads' chunk reads): the
program's spans debwt.ingest.read."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.ingest.read")
