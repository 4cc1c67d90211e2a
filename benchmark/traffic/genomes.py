"""The benchmark's one generator of genome collections, and the input
each build gets.

A configuration's `collection` names a base-genome model and its sizes.
The first two models make one base genome and `genomes - 1` copies of
it with point substitutions (deBWT's target: near-identical genomes),
with the random draws of the repo's two bench generators in the same
order, so that seed 0 gives the collections whose hashes and counts
.bench_cache.json records:

  "repeats"  bench.synth_reads: pieces of 5,000 to 30,000 random bases,
             and one fragment of `repeat_len` bases (bench.synth_reads:
             a 50th of a genome) reused at `repeat_frac` of the pieces
  "uniform"  tools/bench_ooc.py's synth_concat: uniform random bases

The third is a read set, the classic BWT input (BCR, ropebwt2):

  "reads"    a uniform genome of `genome_mbp` Mbp sequenced to
             `coverage` in reads of `read_len` bases, each starting at a
             uniform position, a share `rc_share` of them reverse
             complements, each base substituted with probability
             `error_rate`

Every build of a run gets its own input: the collection with one point
substitution drawn from (seed, build index), so that no build can be
answered by an earlier one. Build 0 is the warm-up.

NumPy and the standard library only: the program's own copy
(debwt_tpu_torch.synth) may change; this one does not.
"""

from __future__ import annotations

import numpy as np


def make_codes(col: dict, seed: int):
    """(codes uint8, lengths int64): the genomes back to back."""
    model = col["model"]
    if model == "repeats":
        return _repeats(col["mbp"], seed, col["genomes"],
                        col["mutation_rate"], col["repeat_frac"],
                        col["repeat_len"])
    if model == "uniform":
        return _uniform(col["mbp"], seed, col["genomes"],
                        col["mutation_rate"])
    if model == "reads":
        return _reads(col["genome_mbp"], seed, col["read_len"],
                      col["coverage"], col["error_rate"], col["rc_share"])
    raise ValueError(f"unknown collection model {model!r}")


def _mutate(rng, gen: np.ndarray, n_mut: int):
    idx = rng.choice(len(gen), size=n_mut, replace=False)
    gen[idx] = (gen[idx] + rng.integers(1, 4, size=n_mut)) % 4


def _pieces(rng, per_genome: int, frag_len: int, repeat_frac: float):
    """The base genome's pieces, in bench.synth_reads' draws: the
    fragment first, then pieces until the genome is full, each the
    fragment again at repeat_frac, else 5,000 to 30,000 random bases."""
    frag = rng.choice(4, size=frag_len).astype(np.uint8)
    parts, size = [], 0
    while size < per_genome:
        if rng.random() < repeat_frac:
            parts.append(frag)
        else:
            parts.append(rng.choice(
                4, size=int(rng.integers(5_000, 30_000))).astype(np.uint8))
        size += len(parts[-1])
    return parts


def _repeats(mbp, seed, n_genomes, mutation_rate, repeat_frac, repeat_len):
    """bench.synth_reads, with the fragment's length a parameter."""
    rng = np.random.default_rng(seed)
    per_genome = int(mbp * 1e6) // n_genomes
    parts = _pieces(rng, per_genome, repeat_len, repeat_frac)
    base = np.concatenate(parts)[:per_genome]
    genomes = []
    for g in range(n_genomes):
        gen = base.copy()
        if g:
            _mutate(rng, gen, int(len(gen) * mutation_rate))
        genomes.append(gen)
    lengths = np.array([len(g) for g in genomes], dtype=np.int64)
    return np.concatenate(genomes), lengths


def _uniform(mbp, seed, n_genomes, mutation_rate):
    rng = np.random.default_rng(seed)
    per = int(mbp * 1e6) // n_genomes
    # an int64 draw narrowed, as the original draws it (same genomes)
    base = rng.integers(0, 4, size=per, dtype=np.int64).astype(np.uint8)
    genomes = []
    for g in range(n_genomes):
        gen = base.copy()
        if g:
            _mutate(rng, gen, int(per * mutation_rate))
        genomes.append(gen)
    del base
    return np.concatenate(genomes), np.full(n_genomes, per, dtype=np.int64)


def _reads(genome_mbp, seed, read_len, coverage, error_rate, rc_share):
    """The draws, in this order: the genome, each read's start, which
    reads are reverse complements, the number of substituted bases
    (binomial: each base independently), their places, their shifts."""
    rng = np.random.default_rng(seed)
    size = int(genome_mbp * 1e6)
    n_reads = int(coverage * size / read_len)
    genome = rng.integers(0, 4, size=size, dtype=np.uint8)
    starts = rng.integers(0, size - read_len + 1, size=n_reads)
    rc = rng.random(n_reads) < rc_share
    reads = np.lib.stride_tricks.sliding_window_view(genome, read_len)[starts]
    del genome
    reads[rc] = 3 - reads[rc, ::-1]
    codes = reads.reshape(-1)
    n_err = int(rng.binomial(codes.shape[0], error_rate))
    idx = rng.choice(codes.shape[0], size=n_err, replace=False)
    codes[idx] = (codes[idx] + rng.integers(1, 4, size=n_err)) % 4
    return codes, np.full(n_reads, read_len, dtype=np.int64)


def substitution(seed: int, build: int, n_codes: int) -> tuple[int, int]:
    """(code index, shift 1..3) of build `build`'s point substitution:
    the base at that index becomes (base + shift) % 4."""
    rng = np.random.default_rng([seed % (1 << 64), 1, build])
    return int(rng.integers(n_codes)), int(rng.integers(1, 4))


def text_index(lengths: np.ndarray, q: int) -> int:
    """Position in r_0 # r_1 # ... $ of code index q (one separator
    follows each read)."""
    return q + int(np.searchsorted(np.cumsum(lengths), q, side="right"))
