"""Core host-side data types.

`SequenceCollection` is the ingested text: the concatenation
r_0 # r_1 # ... # r_{n-1} $ as a 2-bit code array (separators stored as
T=3) plus the separator-position metadata — the equivalent of the
reference's packed `bin/reference` + `bin/specialSA` pair
(src/collect#$.c:66-130), held as arrays instead of temp files.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from debwt_tpu_torch import constants as K


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Configuration for one BWT construction run.

    m: the (k+1)-mer counting length (reference -k flag, 12..32).
       The de Bruijn node length is k = m - 1.
    """

    m: int = K.DEFAULT_M
    # Validate internal invariants (costs extra device work).
    check: bool = False

    @property
    def k(self) -> int:
        return self.m - 1

    def __post_init__(self):
        if not (K.MIN_M <= self.m <= K.MAX_M):
            raise ValueError(
                f"-k/m must be in [{K.MIN_M}, {K.MAX_M}], got {self.m}"
            )


@dataclasses.dataclass(frozen=True)
class SequenceCollection:
    """The separator-joined text of a read collection.

    x2:  uint8[N] codes 0..3, separators stored as 3 (T).
    sep: int64[n] sorted positions of the n separators; sep[n-1] == N-1.
    """

    x2: np.ndarray
    sep: np.ndarray

    @property
    def n_reads(self) -> int:
        return int(self.sep.shape[0])

    @property
    def bwt_len(self) -> int:
        return int(self.x2.shape[0])

    @property
    def x6(self) -> np.ndarray:
        """uint8[N] codes 0..5 with separators restored to #=4 / $=5."""
        out = self.x2.copy()
        out[self.sep[:-1]] = K.SHARP
        out[self.sep[-1]] = K.DOLLAR
        return out

    @classmethod
    def from_concat(
        cls, codes: np.ndarray, lengths: np.ndarray
    ) -> "SequenceCollection":
        """Build from concatenated read codes (uint8, 0..3) plus
        per-read lengths — the allocation-free path for large
        collections (no per-read Python objects; all vectorized)."""
        lengths = np.asarray(lengths, dtype=np.int64)
        if lengths.size == 0:
            raise ValueError("empty read collection")
        if int(lengths.min(initial=np.iinfo(np.int64).max)) < K.MIN_READ_LEN:
            raise ValueError(
                f"read length {int(lengths.min())} <= 32; the reference "
                "enforces length > 32 (src/collect#$.c:41-45)"
            )
        total = int(lengths.sum())
        if codes.shape[0] != total:
            raise ValueError(
                f"codes length {codes.shape[0]} != sum(lengths) {total}"
            )
        if codes.size and codes.max() > 3:
            raise ValueError("code arrays must be over 0..3")
        n = lengths.shape[0]
        sep = np.cumsum(lengths + 1) - 1
        x2 = np.empty(total + n, dtype=np.uint8)
        is_sep = np.zeros(total + n, dtype=bool)
        is_sep[sep] = True
        x2[sep] = K.T
        x2[~is_sep] = codes
        return cls(x2=x2, sep=sep)

    @classmethod
    def from_reads(cls, reads: Sequence[str | bytes | np.ndarray]) -> "SequenceCollection":
        """Build from a list of reads (strings over ACGT or code arrays)."""
        if not reads:
            raise ValueError("empty read collection")
        parts = []
        seps = []
        pos = 0
        lut = np.full(256, 255, dtype=np.uint8)
        for b, v in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3)):
            for ch in b:
                lut[ord(ch)] = v
        for r in reads:
            if isinstance(r, str):
                r = r.encode()
            if isinstance(r, (bytes, bytearray)):
                codes = lut[np.frombuffer(bytes(r), dtype=np.uint8)]
                if (codes == 255).any():
                    bad = bytes(r)[int(np.argmax(codes == 255))]
                    raise ValueError(
                        f"non-ACGT character {bad!r} in read; apply an "
                        "N-policy first (debwt_tpu_torch.io.fasta)"
                    )
            else:
                codes = np.asarray(r, dtype=np.uint8)
                if codes.size and codes.max() > 3:
                    raise ValueError("code arrays must be over 0..3")
            if codes.shape[0] < K.MIN_READ_LEN:
                raise ValueError(
                    f"read length {codes.shape[0]} <= 32; the reference "
                    "enforces length > 32 (src/collect#$.c:41-45)"
                )
            parts.append(codes)
            parts.append(np.array([K.T], dtype=np.uint8))  # separator as T
            pos += codes.shape[0]
            seps.append(pos)
            pos += 1
        x2 = np.concatenate(parts)
        sep = np.asarray(seps, dtype=np.int64)
        return cls(x2=x2, sep=sep)
