"""Synthetic genome collections: copies of the repo's two generators,
returning codes instead of strings.

Both make one base genome plus n_genomes - 1 copies with point
mutations — the deBWT target workload, a collection of near-identical
genomes — with the random draws of the original, in the same order, so
the same (mbp, seed) gives the same genomes and the counts and hashes
recorded for them in .bench_cache.json apply:

  synth_codes         bench.synth_reads: a base genome with internal
                      repeat content (the `ref_mbp*` reference hashes)
  synth_concat_codes  tools/bench_ooc.py's synth_concat: a plain random
                      base genome (the `grouped_mbp*` and `ooc_mbp*`
                      rows' sp_len and n_blue, at 1 and 3 Gbp); its SP
                      stream is about 0.55% of the text, where
                      synth_codes' is over a fifth

Returning codes skips the per-genome string join (140 M characters at
140 Mbp).
"""

from __future__ import annotations

import numpy as np

from debwt_tpu_torch.types import SequenceCollection


def synth_codes(mbp: float, seed: int = 0, n_genomes: int = 4,
                mutation_rate: float = 2e-3, repeat_frac: float = 0.1):
    """(codes uint8, lengths int64) of the n_genomes genomes, back to
    back — the input of SequenceCollection.from_concat."""
    rng = np.random.default_rng(seed)
    per_genome = int(mbp * 1e6) // n_genomes
    # base genome with ~repeat_frac internal repeat reuse
    frag = rng.choice(4, size=max(1, per_genome // 50)).astype(np.uint8)
    parts, size = [], 0
    while size < per_genome:
        if rng.random() < repeat_frac:
            parts.append(frag)
        else:
            piece = rng.choice(4, size=int(rng.integers(5_000, 30_000))).astype(np.uint8)
            parts.append(piece)
        size += len(parts[-1])
    base = np.concatenate(parts)[:per_genome]
    genomes = []
    for g in range(n_genomes):
        gen = base.copy()
        if g:
            n_mut = int(len(gen) * mutation_rate)
            idx = rng.choice(len(gen), size=n_mut, replace=False)
            gen[idx] = (gen[idx] + rng.integers(1, 4, size=n_mut)) % 4
        genomes.append(gen)
    lengths = np.array([len(g) for g in genomes], dtype=np.int64)
    return np.concatenate(genomes), lengths


def synth_collection(mbp: float, seed: int = 0) -> SequenceCollection:
    return SequenceCollection.from_concat(*synth_codes(mbp, seed))


def synth_concat_codes(mbp: float, seed: int = 0, n_genomes: int = 4,
                       mutation_rate: float = 2e-3):
    """(codes uint8, lengths int64) of tools/bench_ooc.py's synth_concat
    collection, back to back — the input of SequenceCollection.from_concat.
    At 3000 Mbp the base genome's int64 draw is a 6 GB transient, as in
    the original (a draw in pieces would not give the same genomes)."""
    rng = np.random.default_rng(seed)
    per = int(mbp * 1e6) // n_genomes
    base = rng.integers(0, 4, size=per, dtype=np.int64).astype(np.uint8)
    genomes = []
    for g in range(n_genomes):
        gen = base.copy()
        if g:
            n_mut = int(per * mutation_rate)
            idx = rng.choice(per, size=n_mut, replace=False)
            gen[idx] = (gen[idx] + rng.integers(1, 4, size=n_mut)) % 4
        genomes.append(gen)
    del base
    return np.concatenate(genomes), np.full(n_genomes, per, dtype=np.int64)


def synth_concat_collection(mbp: float, seed: int = 0) -> SequenceCollection:
    return SequenceCollection.from_concat(*synth_concat_codes(mbp, seed))
