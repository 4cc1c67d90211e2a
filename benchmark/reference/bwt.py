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

Two paths sort. `suffix_array` sorts the whole text at once, about 49
device bytes a position at its peak, for N < 2^31. `blocked_suffix_array` sorts a
block of whole groups at a time, for texts up to MAX_N positions (the
program's grouped tier's largest). `reference_answer` takes the blocked
path where the one sort cannot: N >= 2^31, or more bytes than the card
has free.

It imports torch and numpy only: nothing of the program, whose outputs
it reads only to judge them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

A, C, G, T, SHARP, DOLLAR = range(6)
_FIRST = 21          # characters of the first round's key, 3 bits each
_SHIFT = 31          # rank bits of the pair keys (ranks < N < 2^31)
_PACK_WORDS = 1 << 22
_SPAN = 1 << 28      # positions text6, bwt_from_sa and the sidecars take at once
MAX_N = 3_758_096_384  # the grouped tier's largest text (grouped.MAX_N)
BLOCK = 1 << 28      # positions of a block of the blocked sort, at most
# device bytes at the peaks, measured on an H100: the one sort 49 a
# position (hap4_1000); the blocked sort 18 a position (the text, sa,
# int64 ranks, heads) and 62 a block position (N = 3,000,000,004)
_ONE_SORT_BYTES = 50
_BLOCK_BYTES = 64
_BUCKET_CHARS = 8    # characters of the blocked sort's first buckets


def text6(codes: np.ndarray, lengths: np.ndarray, dev) -> torch.Tensor:
    """uint8[N] codes 0..5 of r_0 # r_1 # ... $ on `dev`, from the
    genomes back to back and their lengths."""
    n = lengths.shape[0]
    sep = torch.from_numpy(np.cumsum(lengths + 1) - 1).to(dev)
    N = int(lengths.sum()) + n
    src = torch.from_numpy(codes).to(dev)
    x = torch.empty(N, dtype=torch.uint8, device=dev)
    for a in range(0, N, _SPAN):
        t = torch.arange(a, min(N, a + _SPAN), device=dev)
        k = torch.searchsorted(sep, t)      # separators before t
        at_sep = sep[k.clamp(max=n - 1)] == t
        x[a: a + t.shape[0]] = torch.where(
            at_sep, SHARP, src[(t - k).clamp(max=src.shape[0] - 1)])
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


def _bucket_chars(N: int, first: int) -> int:
    """Characters of the first buckets: about 8^c >= 64 N, at most
    _BUCKET_CHARS (2^24 buckets) and `first`."""
    return max(1, min(_BUCKET_CHARS, first, (N.bit_length() + 2) // 3 + 2))


def _buckets(x: torch.Tensor, a: int, b: int, chars: int) -> torch.Tensor:
    """int32 bucket of positions a..b-1: their first `chars` characters,
    3 bits each, past the end 0."""
    N = x.shape[0]
    bk = torch.zeros(b - a, dtype=torch.int32, device=x.device)
    for t in range(chars):
        bk <<= 3
        if a + t < N:
            hi = min(b + t, N)
            bk[: hi - a - t] |= x[a + t: hi]
    return bk


def _first_key(x: torch.Tensor, p: torch.Tensor, first: int) -> torch.Tensor:
    """int64 key of positions p: their first `first` characters, 3 bits
    each, past the end 0 (suffix_array's first key)."""
    N = x.shape[0]
    key = torch.zeros(p.shape[0], dtype=torch.int64, device=x.device)
    for t in range(first):
        key <<= 3
        q = p + t
        key |= torch.where(q < N, x[q.clamp(max=N - 1)], 0)
    return key


def _too_large(size: int, chars: int, block: int):
    return ValueError(f"{size} suffixes share their first {chars} characters,"
                      f" more than a block of {block} positions")


def _first_pass(x, first, block, sa, head, rank):
    """Sorts the suffixes on their first `first` characters into sa,
    marks each group's first index in head and gives each position the
    index of its group's head as its rank. Positions are bucketed on
    their first few characters; a block of whole buckets is gathered by
    one scan of the text and sorted at once."""
    N, dev = x.shape[0], x.device
    chars = _bucket_chars(N, first)
    counts = torch.zeros(1 << 3 * chars, dtype=torch.int64, device=dev)
    for a in range(0, N, block):
        counts += torch.bincount(_buckets(x, a, min(N, a + block), chars),
                                 minlength=counts.shape[0])
    ends = counts.cumsum(0).cpu().numpy()
    b0, off = 0, 0
    while off < N:
        b1 = int(np.searchsorted(ends, off + block, side="right"))
        n = int(ends[b1 - 1]) - off if b1 else 0
        if n == 0:      # the next bucket that is not empty
            raise _too_large(int(ends[b1]) - off, chars, block)
        parts = []
        for a in range(0, N, block):
            bk = _buckets(x, a, min(N, a + block), chars)
            parts.append(torch.nonzero((bk >= b0) & (bk < b1)).flatten() + a)
            del bk
        p = torch.cat(parts)
        del parts
        ks, order = torch.sort(_first_key(x, p, first))
        p = p[order]
        del order
        _settle(sa, head, rank, off, p, ks)
        del p, ks
        b0, off = b1, off + n


def _head_of(heads: torch.Tensor, off: int) -> torch.Tensor:
    """off + the index of each place's group head, where heads marks
    each group's first place (heads[0] among them). A scan and a gather,
    not torch.cummax, whose CUDA kernel scans one long row in one block."""
    first = torch.nonzero(heads).flatten()
    first += off
    return first[torch.cumsum(heads, 0) - 1]


def _settle(sa, head, rank, off, p, ks):
    """sa[off:off + n] = p, sorted on keys ks, with its heads and ranks."""
    n = p.shape[0]
    sa[off: off + n] = p
    new = torch.ones(n, dtype=torch.bool, device=p.device)
    torch.ne(ks[1:], ks[:-1], out=new[1:])
    head[off: off + n] = new
    rank[p] = _head_of(new, off).to(rank.dtype)


def _block_end(head: torch.Tensor, c: int, block: int, h: int) -> int:
    """The end of the block that starts at index c, a group's head: the
    last head in (c, c + block], so that it holds whole groups."""
    N = head.shape[0] - 1
    if c + block >= N:
        return N
    w = head[c + 1: c + block + 1].flip(0)
    j = int(torch.argmax(w.to(torch.uint8)))
    if not bool(w[j]):
        size = 1 + int(torch.argmax(head[c + 1:].to(torch.uint8)))
        raise _too_large(size, h, block)
    return c + block - j


def _block_for(N: int, rank_bytes: int, dev) -> int:
    """BLOCK, halved on a card until the sort's arrays and a block's work
    fit what is free (down to 2^20)."""
    block = BLOCK
    if dev.type == "cuda":
        need = (9 + rank_bytes) * N
        while block > 1 << 20 and need + _BLOCK_BYTES * block > _free_bytes(dev):
            block //= 2
    return block


def blocked_suffix_array(x: torch.Tensor, depth: int | None = None,
                         first: int = _FIRST, block: int | None = None,
                         narrow_limit: int = 1 << 31,
                         stats: dict | None = None) -> torch.Tensor:
    """suffix_array by blocks, for N up to MAX_N: int64 suffix array of
    x, with `depth` the same control order.

    Prefix doubling on group heads. A group is the suffixes that share
    their first h characters, a run of sa; a position's rank is the sa
    index of its group's head (int32 where N < narrow_limit, else
    int64), so it stays below N. A round cuts sa into blocks of whole
    groups of at most `block` positions (by default BLOCK, or less where
    the card has not the room), skips the groups of one, and
    sorts each block's other groups on (group, rank of the suffix h
    on); it writes sa and the heads as it goes and the ranks only once
    every block has read them. A group larger than a block raises with
    its size, and so does a first bucket (the suffixes that share their
    first few characters) larger than a block. `stats` gets the block,
    the bytes of a rank, the seconds of the first sort, and for each
    round after it the positions in groups of two or more and its
    seconds."""
    N, dev = x.shape[0], x.device
    if N > MAX_N:
        raise ValueError(f"text of {N} characters: more than {MAX_N}")
    bits = max(1, N.bit_length())       # a rank, or a position, < 2^bits
    rank_dtype = torch.int32 if N < narrow_limit else torch.int64
    block = block or _block_for(N, rank_dtype.itemsize, dev)
    t0 = time.perf_counter()
    sa = torch.empty(N, dtype=torch.int64, device=dev)
    head = torch.empty(N + 1, dtype=torch.bool, device=dev)
    head[N] = True                      # the end closes the last group
    rank = torch.empty(N, dtype=rank_dtype, device=dev)
    _first_pass(x, first, block, sa, head, rank)
    h, open_, round_s = first, [], []
    while not bool(head.all()):
        t1 = time.perf_counter()
        round_s.append(t1 - t0)
        t0 = t1
        tie = depth is not None and h >= depth
        touched, c, opened = [], 0, 0
        while c < N:
            end = _block_end(head, c, block, h)
            idx = torch.nonzero(~(head[c:end] & head[c + 1: end + 1]))
            if idx.shape[0]:
                opened += idx.shape[0]
                idx = idx.flatten() + c
                s = sa[idx]
                key = torch.cumsum(head[idx], 0)    # the group, from 1
                if int(key[-1]).bit_length() + bits > 63:
                    raise ValueError(f"{int(key[-1])} groups in a block:"
                                     f" keys of {bits}-bit ranks overflow")
                key -= 1
                key <<= bits
                # in a group of two or more, s + h < N: '$' is unique
                key |= s if tie else rank[s + h]
                ks, order = torch.sort(key)
                del key
                sa[idx] = s[order]
                del s, order
                new = torch.ones(idx.shape[0], dtype=torch.bool, device=dev)
                torch.ne(ks[1:], ks[:-1], out=new[1:])
                head[idx] = new
                del ks, new
                touched.append((c, end))
            del idx
            c = end
        for c, end in touched:
            rank[sa[c:end]] = _head_of(head[c:end], c).to(rank.dtype)
        open_.append(opened)
        if tie:
            break
        h *= 2
    round_s.append(time.perf_counter() - t0)
    if stats is not None:
        stats.update(block=block, rank_bytes=rank.element_size(),
                     first_s=round_s[0], rounds=len(open_), open=open_,
                     round_s=round_s[1:])
    del rank, head
    return sa


def bwt_from_sa(x: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """uint8 BWT codes 0..5: the character before each sorted suffix
    (position -1 wraps to N - 1, '$')."""
    N = x.shape[0]
    out = torch.empty(N, dtype=torch.uint8, device=x.device)
    for a in range(0, N, _SPAN):
        prev = sa[a: a + _SPAN] - 1
        prev[prev < 0] = N - 1
        out[a: a + prev.shape[0]] = x[prev]
    return out


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


def _free_bytes(dev) -> int:
    """Bytes free on a card, the allocator's cached bytes counted free."""
    return (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))


def one_sort_fits(x: torch.Tensor) -> bool:
    """Whether suffix_array can sort x: N < 2^31 and, on a card, about
    50 bytes a position free."""
    N = x.shape[0]
    if N >= 1 << _SHIFT:
        return False
    return x.device.type != "cuda" or _ONE_SORT_BYTES * N <= _free_bytes(
        x.device)


def _positions(bwt6: torch.Tensor, code: int) -> np.ndarray:
    """int64 indices of `code` in bwt6, a span at a time."""
    return torch.cat([
        torch.nonzero(bwt6[a: a + _SPAN] == code).flatten() + a
        for a in range(0, bwt6.shape[0], _SPAN)]).cpu().numpy()


def reference_answer(x: torch.Tensor, depth: int | None = None,
                     blocked: bool | None = None, stats: dict | None = None):
    """(packed uint8 tensor, '#' positions int64, '$' positions int64)
    of x. With `depth`, the control: suffixes sorted on their first
    `depth` characters only, ties by text position (a de Bruijn graph
    BWT that leaves branches longer than k unresolved). `blocked`
    forces a path; by default the one sort where it fits, else the
    blocked sort (which fills `stats`)."""
    first = _FIRST if depth is None else depth // 2
    if blocked is None:
        blocked = not one_sort_fits(x)
    if blocked:
        sa = blocked_suffix_array(x, depth, first=first, stats=stats)
    else:
        sa = (suffix_array(x) if depth is None
              else suffix_array(x, depth, first=first))
    bwt6 = bwt_from_sa(x, sa)
    del sa
    sharp = _positions(bwt6, SHARP)
    dollar = _positions(bwt6, DOLLAR)
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
