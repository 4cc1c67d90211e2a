"""Alphabet and encoding constants shared across the pipeline.

The 6-letter working alphabet (reference: trans[] table, src/main.c:18-23):

    A=0  C=1  G=2  T=3  #=4  $=5

'#' terminates every read except the last, which is terminated by '$'.
Both are encoded as the 'T' dimer (3) in 2-bit packed arrays
(reference: src/collect#$.c:82, src/insertCase3.c:84-95); the 6-letter
codes exist only in unpacked working arrays and in sidecar metadata.
"""

A, C, G, T = 0, 1, 2, 3
SHARP = 4    # '#'  read separator
DOLLAR = 5   # '$'  final terminator (unique maximum)

BASES = "ACGT"
ALPHA6 = "ACGT#$"

# Minimum read length enforced by the reference (src/collect#$.c:41-45):
# every read must be strictly longer than 32 bases so that no k-window
# (k <= 31) ever spans two separators.
MIN_READ_LEN = 33

# k-mer length m (the Jellyfish counting length, reference
# KMER_LENGTH_PlusOne) must be in [12, 32]; the de Bruijn node length is
# k = m - 1 (reference: src/main.c:41-47).
MIN_M, MAX_M, DEFAULT_M = 12, 32, 32

# Tail padding: the reference appends 32 'T' bases after '$'
# (src/collect#$.c:87-90) so that 32-base window reads never run off the
# packed array. We keep the same convention for window extraction.
TAIL_PAD = 32

CODE_OF = {c: i for i, c in enumerate(ALPHA6)}
