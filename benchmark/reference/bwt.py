"""The plain reference: the BWT of r_0 # r_1 # ... # r_{n-1} $ by a
suffix sort, in plain PyTorch, and the comparison that decides
`correct`.

deBWT's output is the BWT of a plain lexicographic suffix sort over the
6-letter alphabet A < C < G < T < # < $, in which two '#' compare equal
and the comparison goes on into the next read (the order the program's
README and its golden model state, held by the reference binary's
hashes). This file sorts the suffixes by prefix doubling: ranks of the
first 21 characters (3 bits each), then (rank[i], rank[i + h]) pairs,
h doubling until every rank is distinct. '$' is unique and the largest
character, so no comparison runs past the end of the text.

It imports torch and numpy only: nothing of the program, whose outputs
it reads only to judge them.
"""

from __future__ import annotations

import numpy as np
import torch

A, C, G, T, SHARP, DOLLAR = range(6)
_FIRST = 21          # characters of the first round's key, 3 bits each
_SHIFT = 31          # rank bits of the pair keys (ranks < N < 2^31)
_PACK_WORDS = 1 << 22


def text6(codes: np.ndarray, lengths: np.ndarray, dev) -> torch.Tensor:
    """uint8[N] codes 0..5 of r_0 # r_1 # ... $ on `dev`, from the
    genomes back to back and their lengths."""
    n = lengths.shape[0]
    sep = torch.from_numpy(np.cumsum(lengths + 1) - 1).to(dev)
    N = int(lengths.sum()) + n
    x = torch.empty(N, dtype=torch.uint8, device=dev)
    is_sep = torch.zeros(N, dtype=torch.bool, device=dev)
    is_sep[sep] = True
    x[~is_sep] = torch.from_numpy(codes).to(dev)
    x[sep[:-1]] = SHARP
    x[sep[-1]] = DOLLAR
    return x


def _dense_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each sorted position: the number of distinct keys before
    its own (int64)."""
    r = torch.zeros_like(sorted_keys)
    torch.cumsum(sorted_keys[1:] != sorted_keys[:-1], 0, out=r[1:])
    return r


def suffix_array(x: torch.Tensor, depth: int | None = None,
                 first: int = _FIRST) -> torch.Tensor:
    """int64 suffix array of x (codes 0..5, a unique largest last
    character). With `depth`, suffixes are sorted on their first
    `depth` or more characters only (doubling stops once h >= depth)
    and ties go by text position: the control's order, not deBWT's."""
    N = x.shape[0]
    if N >= 1 << _SHIFT:
        raise ValueError(f"text of {N} characters: ranks need {_SHIFT} bits")
    key = torch.zeros(N, dtype=torch.int64, device=x.device)
    for t in range(first):
        key <<= 3
        key[: N - t] |= x[t:]
    h = first
    while True:
        sk, order = torch.sort(key)
        del key
        r = _dense_ranks(sk)
        del sk
        distinct = int(r[-1]) + 1 == N
        rank = torch.empty(N, dtype=torch.int32, device=x.device)
        rank[order] = r.to(torch.int32)
        del r
        if distinct:
            return order
        if depth is not None and h >= depth:
            del order
            key = rank.to(torch.int64) << _SHIFT
            key |= torch.arange(N, dtype=torch.int64, device=x.device)
            del rank
            return torch.sort(key).indices
        del order
        key = rank.to(torch.int64) << _SHIFT
        if h < N:
            key[: N - h] |= (rank[h:] + 1).to(torch.int64)
        del rank
        h *= 2


def bwt_from_sa(x: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """uint8 BWT codes 0..5: the character before each sorted suffix
    (position -1 wraps to N - 1, '$')."""
    prev = sa - 1
    prev[prev < 0] = x.shape[0] - 1
    return x[prev]


def pack(bwt6: torch.Tensor) -> torch.Tensor:
    """The on-disk `<obj>` as uint8: little-endian u64 words, 32 bases a
    word, the first in bits 63:62, separators as T, zero-padded."""
    N = bwt6.shape[0]
    n_words = (N + 31) // 32
    out = torch.empty(n_words, dtype=torch.int64, device=bwt6.device)
    shifts = torch.arange(62, -1, -2, dtype=torch.int64, device=bwt6.device)
    for w0 in range(0, n_words, _PACK_WORDS):
        w1 = min(n_words, w0 + _PACK_WORDS)
        c = bwt6[32 * w0: 32 * w1].clamp(max=T).to(torch.int64)
        if c.shape[0] < 32 * (w1 - w0):
            c = torch.cat([c, c.new_zeros(32 * (w1 - w0) - c.shape[0])])
        # disjoint 2-bit fields: the sum is their OR
        out[w0:w1] = (c.view(-1, 32) << shifts).sum(1)
    return out.view(torch.uint8)


class Answer:
    """What one build returned: the `<obj>` bytes, the '#' positions and
    the '$' position."""

    def __init__(self, obj: bytes, sharp, dollar: int):
        self.obj = obj
        self.sharp = np.asarray(sharp, dtype=np.int64)
        self.dollar = int(dollar)

    def save(self, stem) -> None:
        """As the CLI writes it: `<stem>`, and `<stem>.#`, `<stem>.$` of
        little-endian uint64 positions."""
        with open(stem, "wb") as f:
            f.write(self.obj)
        self.sharp.astype("<u8").tofile(f"{stem}.#")
        np.array([self.dollar], dtype="<u8").tofile(f"{stem}.$")

    @classmethod
    def load(cls, stem) -> "Answer":
        with open(stem, "rb") as f:
            obj = f.read()
        return cls(obj, np.fromfile(f"{stem}.#", dtype="<u8").astype(np.int64),
                   int(np.fromfile(f"{stem}.$", dtype="<u8")[0]))


def reference_answer(x: torch.Tensor, depth: int | None = None):
    """(packed uint8 tensor, '#' positions int64, '$' positions int64)
    of x. With `depth`, the control: suffixes sorted on their first
    `depth` characters only, ties by text position (a de Bruijn graph
    BWT that leaves branches longer than k unresolved)."""
    sa = (suffix_array(x) if depth is None
          else suffix_array(x, depth, first=depth // 2))
    bwt6 = bwt_from_sa(x, sa)
    del sa
    sharp = torch.nonzero(bwt6 == SHARP).flatten().cpu().numpy()
    dollar = torch.nonzero(bwt6 == DOLLAR).flatten().cpu().numpy()
    packed = pack(bwt6)
    del bwt6
    return packed, sharp.astype(np.int64), dollar.astype(np.int64)


def _positions_off(got: np.ndarray, want: np.ndarray) -> int:
    n = min(got.shape[0], want.shape[0])
    return int(max(got.shape[0], want.shape[0]) - (got[:n] == want[:n]).sum())


def compare(ans: Answer, ref) -> dict:
    """The numbers compared, each 0 when the answer is the reference's:
    bytes of `<obj>` that differ (a length difference counts each
    missing or extra byte), '#' positions that differ, and '$' (1 if it
    differs)."""
    packed, sharp, dollar = ref
    got = torch.frombuffer(bytearray(ans.obj), dtype=torch.uint8).to(packed.device)
    n = min(got.shape[0], packed.shape[0])
    obj_off = (abs(got.shape[0] - packed.shape[0])
               + int((got[:n] != packed[:n]).sum()))
    return {
        "obj_bytes_off": obj_off,
        "sharp_off": _positions_off(ans.sharp, sharp),
        "dollar_off": int(dollar.shape[0] != 1 or ans.dollar != int(dollar[0])),
    }
