"""Separator-window ("special") module — host side.

The reference builds a suffix array of all positions within k of a
separator, sorted with the full-text comparator, and derives from it
the special BWT patch stream, the head/tail k-mer sets, and the
special branch positions (src/collect#$.c:131-634). These arrays are
O(n_reads * k) — tiny next to the text — and irregular, so they stay
on host as NumPy, exactly like the reference keeps them in scalar C.

Key structural facts (proofs in the JAX package's model.py docstring):
  * a special suffix is (window prefix, separator, continuation into
    the next read), so its true order is (6-letter k-window,
    rank of the next read-head suffix);
  * special windows never compare equal to separator-free node
    windows, so in the unit merge specials are singletons tie-broken
    after the node with the equal T-filled key.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import tracing
from debwt_tpu_torch.types import SequenceCollection


@dataclasses.dataclass(frozen=True)
class SpecialData:
    """Host-side special-module outputs (all NumPy).

    Arrays indexed "in special order" follow the true suffix order of
    the n*k special positions.
    """

    spec_pos_sorted: np.ndarray    # int64[n*k] positions, true suffix order
    spec_tfill: np.ndarray         # uint64[n*k] T-filled 2-bit keys, same order
    spec_bwt6: np.ndarray          # uint8[n*k] BWT chars, same order
    spec_branch_pos: np.ndarray    # int64[B] sorted branch positions
    head_keys: np.ndarray          # uint64[<=n] distinct head k-mer keys, sorted
    tail_keys: np.ndarray          # uint64[n] tail k-mer keys, sorted, with dups
    head_rank: np.ndarray          # int64[n] true-order ranks of head suffixes


def key_of_window(x2: np.ndarray, pos: np.ndarray, k: int) -> np.ndarray:
    """uint64 right-aligned 2-bit keys of k-char windows at `pos`."""
    key = np.zeros(pos.shape[0], dtype=np.uint64)
    for i in range(k):
        key = (key << np.uint64(2)) | x2[pos + i].astype(np.uint64)
    return key


CH = 21  # 3-bit characters in one uint64 chunk of rank_suffixes


def rank_suffixes(coll: SequenceCollection, positions: np.ndarray) -> np.ndarray:
    """True lexicographic ranks of the suffixes starting at `positions`
    (ties impossible: every suffix contains the unique '$').

    Iterative refinement: compare 21-char (3-bit) chunks at increasing
    offsets, re-sorting only tied groups. The depth is set by the
    longest common prefix among the candidate suffixes: one round per
    21 characters of it, plus one. A single genome resolves at once;
    near-identical genomes that start alike do not: the benchmark's 50
    Salmonella-sized genomes (4.86 Mbp each, 0.1% substitutions against
    one base) share heads about 4 kb long and take about 150 to 200
    rounds (195 at full size, 146 and 155 at 1 Mbp), about 70 us of
    host work each at n = 50. A chunk is read from the 2-bit text with
    its one possible separator (reads are longer than 21) restored to
    '#' or '$'; reads past the end see '$', the last character.
    """
    m = positions.shape[0]
    if m <= 1:
        return np.zeros(m, dtype=np.int64)
    x2, sep = coll.x2, coll.sep
    last = coll.bwt_len - 1
    cols = np.arange(CH)
    shifts = np.uint64(3) * (CH - 1 - cols).astype(np.uint64)

    def chunk(off):
        idx = positions + off
        s = sep[np.minimum(np.searchsorted(sep, idx), sep.shape[0] - 1)]
        s_chr = np.where(s == last, K.DOLLAR, K.SHARP)
        j = np.minimum(idx[:, None] + cols, last)
        c = np.where(j == s[:, None], s_chr[:, None], x2[j])
        return (c.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)

    rank = np.zeros(m, dtype=np.int64)
    tied = np.ones(m, dtype=bool)
    off = 0
    while tied.any() and off <= last:
        key = chunk(off)
        tracing.count("special_text_bytes", CH * m)
        order = np.lexsort((key, rank))
        r_o, k_o = rank[order], key[order]
        new = np.ones(m, dtype=bool)
        new[1:] = (r_o[1:] != r_o[:-1]) | (k_o[1:] != k_o[:-1])
        newrank = np.cumsum(new) - 1
        rank[order] = newrank
        counts = np.bincount(rank, minlength=m)
        tied = counts[rank] > 1
        off += CH
    return rank


def build_special(coll: SequenceCollection, m: int) -> SpecialData:
    """The special module of `coll` at (k+1)-mer length m.

    It reads O(n_reads * k) bytes of the text, never a copy of it, and
    counts them in counters["special_text_bytes"]: n (2k + 1) for the
    separator windows and their BWT characters, 2 n k for the head and
    tail k-mers, and 21 n a round of the head-suffix ranking (none for
    one read).
    """
    k = m - 1
    x2, sep = coll.x2, coll.sep
    n = coll.n_reads
    N = coll.bwt_len

    heads = np.concatenate([[0], sep[:-1] + 1]).astype(np.int64)
    head_rank = rank_suffixes(coll, heads)

    # the 2k + 1 characters around each separator, positions
    # s - k .. s + k: a read is longer than 32, so s is the only
    # separator among them. Past the end of the text they read the
    # last separator's stored 'T', as the reference pads the text
    # (src/collect#$.c:87-90).
    span = np.arange(-k, k + 1, dtype=np.int64)
    seg = x2[np.minimum(sep[:, None] + span[None, :], N - 1)]
    seg[:-1, k] = K.SHARP
    seg[-1, k] = K.DOLLAR
    tracing.count("special_text_bytes", seg.size + 2 * n * k)

    # special positions grouped per separator: p in [s-k+1, s]
    offs = np.arange(-k + 1, 1, dtype=np.int64)
    spec_pos = (sep[:, None] + offs[None, :]).reshape(-1)
    read_of = np.repeat(np.arange(n, dtype=np.int64), k)
    d = np.repeat(sep, k) - spec_pos  # distance to the separator, in [0, k-1]

    # 6-letter windows (k+1 cols: branch char at p+k included), the
    # one at p = s-k+1+j being seg's columns 1+j .. 1+j+k
    W = np.lib.stride_tricks.sliding_window_view(
        seg[:, 1:], k + 1, axis=1).reshape(n * k, k + 1)

    # continuation rank: '#' specials continue into read (read_of + 1);
    # '$' specials (last read) have pairwise-distinct windows already.
    cont = np.full(spec_pos.shape[0], -1, dtype=np.int64)
    is_sharp = read_of < n - 1
    cont[is_sharp] = head_rank[read_of[is_sharp] + 1]

    order = np.lexsort((cont,) + tuple(W[:, c] for c in range(k - 1, -1, -1)))
    spec_pos_sorted = spec_pos[order]

    # T-filled 2-bit keys (chars at/after the separator become T) —
    # matches seeKMER's flag fill (src/collect#$.c:428-449)
    fill = np.arange(k)[None, :] >= d[:, None]
    W2 = np.where(fill, K.T, W[:, :k]).astype(np.uint8)
    shifts = (np.uint64(2) * (k - 1 - np.arange(k, dtype=np.uint64)))
    tfill_all = (W2.astype(np.uint64) << shifts[None, :]).sum(
        axis=1, dtype=np.uint64
    )
    spec_tfill = tfill_all[order]

    # the character before p, seg's column j: never a separator
    spec_bwt6 = seg[:, :k].reshape(-1)[order]

    # special-branch positions: groups of equal 6-letter windows with
    # >= 2 distinct branch chars (divideKmer, src/collect#$.c:540-601)
    grp_sort = np.lexsort(tuple(W[:, c] for c in range(k - 1, -1, -1)))
    Wg = W[grp_sort, :k]
    cg = W[grp_sort, k]
    gb = np.ones(Wg.shape[0], dtype=bool)
    gb[1:] = (Wg[1:] != Wg[:-1]).any(axis=1)
    gid = np.cumsum(gb) - 1
    n_g = int(gid[-1]) + 1 if gid.size else 0
    ordp = np.lexsort((cg, gid))
    gid_p, cg_p = gid[ordp], cg[ordp]
    newp = np.ones(gid_p.shape[0], dtype=bool)
    newp[1:] = (gid_p[1:] != gid_p[:-1]) | (cg_p[1:] != cg_p[:-1])
    g_distinct = np.bincount(gid_p[newp], minlength=n_g)
    spec_branch_pos = np.sort(spec_pos[grp_sort[(g_distinct >= 2)[gid]]])

    # head and tail k-mers lie inside their reads
    head_keys = np.unique(key_of_window(x2, heads, k))
    tail_keys = np.sort(key_of_window(x2, sep - k, k))

    return SpecialData(
        spec_pos_sorted=spec_pos_sorted,
        spec_tfill=spec_tfill,
        spec_bwt6=spec_bwt6,
        spec_branch_pos=spec_branch_pos,
        head_keys=head_keys,
        tail_keys=tail_keys,
        head_rank=head_rank,
    )
