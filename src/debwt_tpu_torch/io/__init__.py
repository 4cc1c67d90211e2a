from debwt_tpu_torch.io.fasta import (
    NPolicy, read_collection, read_fasta, read_reads,
)
from debwt_tpu_torch.io.writer import read_bwt, read_sidecars, write_bwt

__all__ = ["read_fasta", "read_reads", "read_collection", "NPolicy",
           "write_bwt", "read_bwt", "read_sidecars"]
