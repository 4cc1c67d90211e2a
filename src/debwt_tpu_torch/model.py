"""Exact-semantics NumPy model of the deBWT decomposition.

This is the stage-by-stage specification of the device pipeline, in
plain NumPy (the port's own copy of the JAX package's model.py). It
reproduces the reference binary byte-for-byte — including the cases
where the reference's order deviates from the true lexicographic
suffix order (see below) — and device stages are tested against it.

Order semantics: suffixes are grouped by their k-char window (6-letter
alphabet); groups are ordered lexicographically with
separator-containing ("special") windows T-filled and tie-broken after
the equal node (reference: specialBwtSA T-fill in src/collect#$.c
seeKMER + the `while(specialBwtSA[specialIndex]==transI)` interleave in
src/INandOut.c:418-439). Within a multi-in node, suffixes are ordered
by *plain lexicographic order of SP-code suffixes* (reference cmpSP,
src/sortBlue.c:109-173): the SP code has one 6-letter character per
multi-out position (the branch choice at that event, with the choice
'separator' = 4/5, reference spSpecialIndex).

The branch encode is *exact*: positional SP-suffix comparison equals
true text suffix order even when comparisons cross read boundaries,
because (a) every text divergence at distance >= k from the next
separator creates a shared multi-out node whose aligned branch choices
expose the ordering, (b) divergences within k of a separator create
aligned special-branch events (divideKmer groups), and (c) a
read-end-vs-continue divergence is a tail node (always multi-out) whose
choices are separator (4/5) vs base. So this model provably equals
golden.py's plain suffix sort; the decomposition exists purely so the
device pipeline can be validated stage-by-stage against it.

The *reference binary* deviates from these semantics only through two
out-of-bounds bugs reachable on degenerate tiny inputs (thread-stitch
OOB for thread segments with < 32 SP events, multiCatSP
src/generateSP.c:356; and cmpSP sentinel reads past the '$' marker when
the whole SP stream fits one 32-char window). We implement the clean
semantics; tests/test_oracle.py pins byte parity everywhere outside
those UB regimes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from debwt_tpu_torch import constants as K
from debwt_tpu_torch.golden import suffix_array
from debwt_tpu_torch.types import SequenceCollection


@dataclasses.dataclass
class ModelTrace:
    """Intermediate stage outputs, for unit-testing the device stages."""

    dist: np.ndarray                 # int64[N] distance to next separator
    node_keys: np.ndarray            # uint64[num_nodes] sorted 2-bit keys
    node_cnt: np.ndarray             # int64[num_nodes]
    node_multi_in: np.ndarray        # bool[num_nodes]
    node_multi_out: np.ndarray       # bool[num_nodes]
    node_pred: np.ndarray            # uint8[num_nodes] single-in pred base
    sp_positions: np.ndarray         # int64[L] text positions of SP events
    sp6: np.ndarray                  # uint8[L] SP chars 0..5
    unit_start: np.ndarray           # int64[num_units] BWT coordinates
    unit_is_special: np.ndarray      # bool[num_units]


def window_matrix(x6p: np.ndarray, n: int, k: int) -> np.ndarray:
    """W[p, i] = x6p[p + i] for p in [0, n), i in [0, k]. (k+1 columns:
    the extra column is the branch-choice char at p+k.)"""
    idx = np.arange(n)[:, None] + np.arange(k + 1)[None, :]
    return x6p[idx]


def key_of_rows(rows: np.ndarray) -> np.ndarray:
    """Pack rows of 2-bit codes (values 0..3) into uint64 keys,
    right-aligned (first char most significant)."""
    kk = rows.shape[1]
    shifts = np.uint64(2) * (kk - 1 - np.arange(kk, dtype=np.uint64))
    return (rows.astype(np.uint64) << shifts[None, :]).sum(axis=1, dtype=np.uint64)


def build_model(coll: SequenceCollection, m: int = 32, trace: bool = False):
    k = m - 1
    x6 = coll.x6
    sep = coll.sep
    n_reads = coll.n_reads
    N = coll.bwt_len
    x6p = np.concatenate([x6, np.full(K.TAIL_PAD, K.T, dtype=np.uint8)])

    # --- distances & position classes (collect#$ pass-2 metadata) ---
    nxt = np.searchsorted(sep, np.arange(N), side="left")
    dist = sep[nxt] - np.arange(N)
    is_main = dist >= k               # window [p, p+k) separator-free
    is_special = ~is_main             # dist in [0, k-1]
    heads = np.concatenate([[0], sep[:-1] + 1])  # read-start positions

    W = window_matrix(x6p, N, k)      # N x (k+1) 6-letter chars

    # --- node table (mySort/getKmer/INandOut.mergeKmer equivalent) ---
    main_pos = np.nonzero(is_main)[0]
    main_keys = key_of_rows(W[main_pos, :k])      # sep-free -> 2-bit safe
    order = np.argsort(main_keys, kind="stable")
    sk = main_keys[order]
    sp_ = main_pos[order]
    boundary = np.ones(sk.shape[0], dtype=bool)
    boundary[1:] = sk[1:] != sk[:-1]
    node_id_sorted = np.cumsum(boundary) - 1
    num_nodes = int(node_id_sorted[-1]) + 1 if sk.size else 0
    node_keys = sk[boundary]
    node_cnt = np.bincount(node_id_sorted, minlength=num_nodes)
    node_of_main = np.empty(N, dtype=np.int64)
    node_of_main[sp_] = node_id_sorted

    # multi-out: >=2 distinct branch chars among occurrences, where a
    # dist==k occurrence contributes the 'separator' choice
    # (tailSharp membership, src/INandOut.c:260-266) and dist>k ones
    # contribute the base at p+k (kmer extensions, :267-277).
    choice = x6p[main_pos + k]                     # 0..5 (4/5 iff dist==k)
    distinct_choices = _distinct_per_group(
        node_id_sorted, choice[order], num_nodes
    )
    has_tail = np.zeros(num_nodes, dtype=bool)
    has_tail[node_id_sorted[(choice >= 4)[order]]] = True
    node_multi_out = (distinct_choices >= 2) | has_tail

    # multi-in: head-occurrence membership (headSharp + head$,
    # src/INandOut.c:282-290) or >=2 distinct predecessor bases among
    # in-edges (the four multiIn streams, :292-343). In-edges exist for
    # every non-head occurrence (the m-mer at p-1).
    is_head_occ = np.zeros(N, dtype=bool)
    is_head_occ[heads] = True
    head_occ_m = is_head_occ[main_pos][order]
    pred_m = coll.x2[np.maximum(main_pos - 1, 0)][order]
    nid_nh = node_id_sorted[~head_occ_m]
    pred_nh = pred_m[~head_occ_m]
    distinct_preds = _distinct_per_group(nid_nh, pred_nh, num_nodes)
    has_head = np.zeros(num_nodes, dtype=bool)
    has_head[node_id_sorted[head_occ_m]] = True
    node_multi_in = (distinct_preds >= 2) | has_head
    # single-in predecessor base (valid when not multi-in)
    node_pred = np.zeros(num_nodes, dtype=np.uint8)
    node_pred[nid_nh] = pred_nh

    # --- special module (collect#$ seeKMER/divideKmer equivalent) ---
    spec_pos = np.nonzero(is_special)[0]
    Wspec = W[spec_pos, :k]
    # true-order rank of every suffix (the reference's special SA is
    # sorted with the full-text comparator cmp == true 6-letter order)
    full_rank = np.empty(N, dtype=np.int64)
    full_rank[suffix_array(x6)] = np.arange(N)
    spec_order = np.argsort(full_rank[spec_pos], kind="stable")
    spec_sorted = spec_pos[spec_order]
    # T-fill keys for the unit merge (seeKMER flag logic: every char at
    # or after the first separator becomes T)
    dfill = dist[spec_pos]
    fill_mask = np.arange(k)[None, :] >= dfill[:, None]
    Wfill = np.where(fill_mask, K.T, Wspec).astype(np.uint8)
    spec_tfill = key_of_rows(Wfill)

    # special-branch positions (divideKmer:540-601): groups of equal
    # 6-letter windows among special positions with >=2 distinct
    # branch chars at p+k -> every group member is an SP event.
    spec_choice = x6p[spec_pos + k]
    grp_sort = np.lexsort(
        tuple(Wspec[:, c] for c in range(k - 1, -1, -1))
    )
    Wg = Wspec[grp_sort]
    cg = spec_choice[grp_sort]
    gb = np.ones(Wg.shape[0], dtype=bool)
    gb[1:] = (Wg[1:] != Wg[:-1]).any(axis=1)
    gid = np.cumsum(gb) - 1
    n_g = int(gid[-1]) + 1 if gid.size else 0
    g_distinct = _distinct_per_group(gid, cg, n_g)
    is_branch_grp = g_distinct >= 2
    spec_branch_pos = np.sort(spec_pos[grp_sort[is_branch_grp[gid]]])

    # --- SP stream (generateSP equivalent) ---
    mo_main = main_pos[node_multi_out[node_of_main[main_pos]]]
    sp_positions = np.sort(np.concatenate([mo_main, spec_branch_pos]))
    sp6 = x6p[sp_positions + k]

    # --- blue entries & SP suffix ranks (sortBlue equivalent) ---
    # cmpSP reads past the end of the SP code into its zero ('A') pad
    # (spCodeLen += 32 over calloc'd words, src/generateSP.c); a tie
    # can legitimately continue through the pad, so rank suffixes of
    # the zero-extended string. Pad length L is enough to reach every
    # decision point (the unique '$' marker at offset <= L).
    L = sp_positions.shape[0]
    sp_rank = np.empty(L, dtype=np.int64)
    if L:
        sp6_ext = np.concatenate([sp6, np.zeros(L, dtype=np.uint8)])
        r = np.empty(2 * L, dtype=np.int64)
        r[suffix_array(sp6_ext)] = np.arange(2 * L)
        sp_rank[:] = r[:L]
    blue_mask_m = node_multi_in[node_of_main[main_pos]]
    blue_pos = main_pos[blue_mask_m]
    blue_node = node_of_main[blue_pos]
    blue_spidx = np.searchsorted(sp_positions, blue_pos, side="left")
    if blue_pos.size:
        assert blue_spidx.max() < L, "multi-in position with no SP event after it"
    blue_char = np.where(
        blue_pos == 0,
        K.DOLLAR,
        np.where(is_head_occ[blue_pos], K.SHARP, x6p[np.maximum(blue_pos - 1, 0)]),
    ).astype(np.uint8)
    bsort = np.lexsort((sp_rank[blue_spidx], blue_node))
    # within-node distinct spIdx invariant (termination of cmpSP)
    bs_n, bs_r = blue_node[bsort], blue_spidx[bsort]
    dup = (bs_n[1:] == bs_n[:-1]) & (bs_r[1:] == bs_r[:-1])
    assert not dup.any(), "same-node suffixes sharing an SP index"

    # --- unit merge + assembly (mergeKmer coordinates + insertCase3) ---
    # units: nodes (key, special=0) and specials (tfill key, special=1,
    # tie-broken by true special order)
    u_key = np.concatenate([node_keys, spec_tfill[spec_order]])
    u_special = np.concatenate(
        [np.zeros(num_nodes, np.int8), np.ones(spec_sorted.shape[0], np.int8)]
    )
    u_rank = np.concatenate(
        [np.zeros(num_nodes, np.int64), np.arange(spec_sorted.shape[0])]
    )
    u_order = np.lexsort((u_rank, u_special, u_key))
    u_size = np.concatenate(
        [node_cnt, np.ones(spec_sorted.shape[0], dtype=np.int64)]
    )[u_order]
    unit_start = np.zeros(u_order.shape[0], dtype=np.int64)
    np.cumsum(u_size[:-1], out=unit_start[1:])
    assert u_size.sum() == N

    # node unit starts
    node_start = np.empty(num_nodes, dtype=np.int64)
    spec_bwtpos = np.empty(spec_sorted.shape[0], dtype=np.int64)
    is_node_unit = u_order < num_nodes
    node_start[u_order[is_node_unit]] = unit_start[is_node_unit]
    spec_bwtpos[u_order[~is_node_unit] - num_nodes] = unit_start[~is_node_unit]

    bwt6 = np.empty(N, dtype=np.uint8)
    # case 2 runs
    case2 = ~node_multi_in
    starts = node_start[case2]
    sizes = node_cnt[case2]
    fill_idx = np.repeat(starts, sizes) + _ramp(sizes)
    bwt6[fill_idx] = np.repeat(node_pred[case2], sizes)
    # case 3 (blue): absolute = node_start[node] + rank within node
    seg_start_per_entry = node_start[bs_n]
    occurrence = _ramp_by_group(bs_n)
    bwt6[seg_start_per_entry + occurrence] = blue_char[bsort]
    # specials: p-1 is never a separator (reads are longer than k), so
    # the predecessor is always a plain base
    bwt6[spec_bwtpos] = x6p[spec_sorted - 1]
    # sanity: every slot written
    sharp_pos = np.nonzero(bwt6 == K.SHARP)[0].astype(np.int64)
    (dollar_idx,) = np.nonzero(bwt6 == K.DOLLAR)
    assert dollar_idx.shape[0] == 1

    from debwt_tpu_torch.golden import GoldenBwt

    result = GoldenBwt(
        bwt6=bwt6, sharp_pos=sharp_pos, dollar_pos=int(dollar_idx[0])
    )
    if not trace:
        return result
    return result, ModelTrace(
        dist=dist,
        node_keys=node_keys,
        node_cnt=node_cnt.astype(np.int64),
        node_multi_in=node_multi_in,
        node_multi_out=node_multi_out,
        node_pred=node_pred,
        sp_positions=sp_positions,
        sp6=sp6,
        unit_start=unit_start,
        unit_is_special=(~is_node_unit)[np.argsort(u_order)][num_nodes:],
    )


def _ramp(sizes: np.ndarray) -> np.ndarray:
    """[0..s0), [0..s1), ... concatenated."""
    if sizes.size == 0:
        return np.zeros(0, dtype=np.int64)
    total = int(sizes.sum())
    out = np.ones(total, dtype=np.int64)
    out[0] = 0
    ends = np.cumsum(sizes)[:-1]
    out[ends] = -sizes[:-1] + 1
    return np.cumsum(out)


def _ramp_by_group(sorted_group_ids: np.ndarray) -> np.ndarray:
    """Occurrence index within runs of equal ids (ids must be grouped)."""
    n = sorted_group_ids.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    new = np.ones(n, dtype=bool)
    new[1:] = sorted_group_ids[1:] != sorted_group_ids[:-1]
    idx = np.arange(n, dtype=np.int64)
    starts = idx[new]
    return idx - starts[np.cumsum(new) - 1]


def _distinct_per_group(group_ids: np.ndarray, values: np.ndarray, num_groups: int) -> np.ndarray:
    """Count distinct values per group. group_ids need not be sorted."""
    if group_ids.size == 0:
        return np.zeros(num_groups, dtype=np.int64)
    order = np.lexsort((values, group_ids))
    g, v = group_ids[order], values[order]
    new = np.ones(g.shape[0], dtype=bool)
    new[1:] = (g[1:] != g[:-1]) | (v[1:] != v[:-1])
    return np.bincount(g[new], minlength=num_groups)
