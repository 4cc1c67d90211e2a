"""Golden (specification) model: direct NumPy suffix sort.

This is the executable specification of the output semantics — NOT part
of the device pipeline. The reference binary's output is byte-identical to
a plain lexicographic suffix sort of the separator-joined text over the
6-letter alphabet A<C<G<T<#<$ (verified against the checked-in deBWT
ELF in tests/oracle/). The tortured comparators in the reference
(`cmp` src/collect#$.c:253-311, `cmpSP` src/sortBlue.c:109-173, with
their `minusDimer` separator collation) all reduce to exactly this
order:

  * at the first differing offset, any separator outranks any base
    (minusDimer demotes a competing T below the T-encoded separator;
    G/C/A already compare lower) — so '#'=4, '$'=5;
  * two '#' at the same offset compare equal and comparison continues
    into the following read (the inner distance loop advances both);
  * '$' at equal offsets is resolved by the checka==countRead-1 branch,
    i.e. '$' > '#'.

The model is O(N log^2 N) prefix-doubling; fine up to tens of Mbp, used
as the oracle for every pipeline test.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from debwt_tpu_torch import constants as K
from debwt_tpu_torch.types import SequenceCollection


def suffix_array(x: np.ndarray) -> np.ndarray:
    """Suffix array of int array `x` by prefix doubling.

    Past-the-end is treated as the unique minimum, which is
    order-irrelevant for our text because the unique maximum '$' at
    position N-1 decides every comparison before length ties can.
    """
    n = x.shape[0]
    rank = np.asarray(x, dtype=np.int64)
    step = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        if step < n:
            rank2[: n - step] = rank[step:]
        order = np.lexsort((rank2, rank))
        r_o, r2_o = rank[order], rank2[order]
        diff = np.ones(n, dtype=bool)
        diff[1:] = (r_o[1:] != r_o[:-1]) | (r2_o[1:] != r2_o[:-1])
        new_sorted = np.cumsum(diff) - 1
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_sorted
        if new_sorted[-1] == n - 1:
            return order.astype(np.int64)
        step <<= 1


@dataclasses.dataclass(frozen=True)
class GoldenBwt:
    bwt6: np.ndarray          # uint8[N] codes 0..5
    sharp_pos: np.ndarray     # int64[n-1] BWT positions of '#'
    dollar_pos: int           # BWT position of '$'

    @property
    def bwt2(self) -> np.ndarray:
        """2-bit codes with separators flattened to T (output encoding)."""
        out = self.bwt6.copy()
        out[out >= 4] = K.T
        return out

    def packed(self) -> bytes:
        """Pack to the reference's on-disk format: little-endian u64
        words, 32 bases/word, first base in bits 63:62, zero-padded
        (src/insertCase3.c:36-40,115-117)."""
        return pack_2bit_u64(self.bwt6)


# text characters a block of the packers below (a multiple of 32): the
# transients stay O(block) however long the text
_PACK_BLOCK = 1 << 26

# a packed byte -> its four 2-bit chars, first char in bits 7:6
_UNPACK4 = (
    (np.arange(256, dtype=np.uint8)[:, None] >> np.array([6, 4, 2, 0], np.uint8))
    & 3
).astype(np.uint8)


def pack_2bit_u64(codes: np.ndarray) -> bytes:
    """Codes 0..3 in the reference's on-disk layout: little-endian u64
    words, 32 bases a word, first base in bits 63:62, the last word
    zero-padded. A code of 4 or 5 (a 6-letter BWT's '#' or '$') packs
    as T, as the layout stores separators. Four codes go to a byte,
    first code high, so a word's big-endian bytes are the packed bytes
    in order: each 8-byte group is reversed for little-endian."""
    n = codes.shape[0]
    out = np.zeros(((n + 31) // 32) * 8, dtype=np.uint8)
    for s in range(0, n, _PACK_BLOCK):
        blk = np.minimum(codes[s : s + _PACK_BLOCK], K.T).astype(np.uint8)
        pad = (-blk.shape[0]) % 32
        if pad:
            blk = np.concatenate([blk, np.zeros(pad, np.uint8)])
        q = blk.reshape(-1, 4)
        b = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
        out[s // 4 : s // 4 + b.shape[0]] = b.reshape(-1, 8)[:, ::-1].reshape(-1)
    return out.tobytes()


def unpack_2bit_u64(raw: bytes, n: int) -> np.ndarray:
    """Inverse of pack_2bit_u64: the first n codes (uint8 0..3)."""
    by = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    for s in range(0, n, _PACK_BLOCK):
        grp = by[s // 4 : (s + _PACK_BLOCK) // 4].reshape(-1, 8)[:, ::-1]
        codes = _UNPACK4[grp.reshape(-1)].reshape(-1)
        e = min(n, s + _PACK_BLOCK)
        out[s:e] = codes[: e - s]
    return out


def golden_bwt(coll: SequenceCollection) -> GoldenBwt:
    x6 = coll.x6
    sa = suffix_array(x6)
    prev = sa - 1  # position -1 wraps to N-1, which holds '$'
    bwt6 = x6[prev]
    (sharp_idx,) = np.nonzero(bwt6 == K.SHARP)
    (dollar_idx,) = np.nonzero(bwt6 == K.DOLLAR)
    assert dollar_idx.shape[0] == 1
    return GoldenBwt(
        bwt6=bwt6,
        sharp_pos=sharp_idx.astype(np.int64),
        dollar_pos=int(dollar_idx[0]),
    )


def lf_reconstruct(g: GoldenBwt, n_reads: int) -> np.ndarray:
    """Reconstruct the text backwards from the BWT via LF mapping —
    the resurrected semantics of the reference's dead verification path
    (src/LFsearch.c:49-166). Returns uint8[N] 6-letter codes; equality
    with SequenceCollection.x6 proves invertibility.
    """
    bwt6 = g.bwt6
    n = bwt6.shape[0]
    # occ over the 6-letter alphabet; LF(i) = C[c] + rank(c, i) where the
    # C array orders A<C<G<T<#<$ and all '#' share one bucket whose
    # internal order is BWT order (they are one symbol).
    counts = np.bincount(bwt6, minlength=6)
    cum = np.zeros(7, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    ranks = np.zeros(n, dtype=np.int64)
    for c in range(6):
        mask = bwt6 == c
        ranks[mask] = np.arange(int(mask.sum()), dtype=np.int64)
    out = np.empty(n, dtype=np.uint8)
    # Suffix 0's BWT char is '$'; start there and walk backwards from
    # text position N-1.
    i = int(np.nonzero(bwt6 == K.DOLLAR)[0][0])
    for pos in range(n - 1, -1, -1):
        c = bwt6[i]
        out[pos] = c
        i = int(cum[c] + ranks[i])
    return out
