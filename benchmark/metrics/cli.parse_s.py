"""Seconds a job of the CLI's parse (for FASTA, io.read_collection's cut
of each chunk after its last newline; for FASTQ, io.fasta._stream_reads'
line table, span mask and CR count): the program's spans
debwt.ingest.parse."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.ingest.parse")
