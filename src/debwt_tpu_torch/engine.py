"""Fused single-device engine: the whole classification in ONE sort
(the PyTorch counterpart of the JAX package's engine.py, whose
docstring derives the method).

In short: one row per text position (main rows: separator-free
m-windows; special rows: the host-sorted separator windows) is sorted
once by (m-window key, class+position); the sorted row index IS the BWT
coordinate, and every per-node fact is a segment reduction over the
sorted rows, computed by segmented OR scans (kernel 2,
kernels/seg_or.py). stage_graph runs up to the dynamic SP/blue counts;
stage_finish, sized by them, ranks the SP string by prefix tripling and
scatters the blue chars.

Arguments and outputs follow the JAX engine so that both can be fed the
same padded inputs, with three changes of representation: the text is
its T-padded uint8 codes (the x2p that the JAX engine first unpacks
from 2-bit words: stage_finish keeps the codes anyway, so nothing packs
them); window keys are int64 (one word instead of a (hi, lo) uint32
pair); and the SP event keys are int64 (r_pos << 3 | char overflows
int32 at r_pos >= 2^28).
The third sort operand still packs (class, position) into one int32:

    main row:    pos - 2^29          (negative; ascending position)
    special row: spec_j<<3 | char6   (in [0, 2^29))
    invalid row: 2^29 + row_index    (>= 2^29)
"""

from __future__ import annotations

import torch

from debwt_tpu_torch import ops, tracing
from debwt_tpu_torch.kernels.seg_or import seg_scan_or, seg_suffix_or

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8
BIG = 1 << 29     # class encoding split point (R < 2^29 rows)
POS_STOP = 1 << 29  # stop bit for position-valued OR-carry scans
SENT = 0xFFFFFFFF   # SP event sentinel: sorts last, SENT >> 3 = 2^29 - 1


def _dist_from_sep(is_sep: torch.Tensor, n: int) -> torch.Tensor:
    """dist[p] = (next separator position >= p) - p, as one segmented
    suffix OR-carry: separator rows carry their own position plus the
    stop bit; every row inherits the next separator's position. Rows
    past the last separator (bucket padding) come out negative —
    harmless, they are excluded by pos < n_real everywhere."""
    idx = torch.arange(n, dtype=I32, device=is_sep.device)
    words = torch.where(is_sep, idx | POS_STOP, 0)
    words[-1] |= POS_STOP
    nxt = seg_scan_or(words, stop_bit=POS_STOP) & (POS_STOP - 1)
    return nxt - idx


def _shift_in(x: torch.Tensor, first) -> torch.Tensor:
    """[first, x[0], ..., x[-2]]."""
    return torch.cat([torch.full_like(x[:1], first), x[:-1]])


def _changed(x: torch.Tensor) -> torch.Tensor:
    """bool[R]: x[i] != x[i-1], False at row 0."""
    return torch.cat([torch.zeros_like(x[:1], dtype=torch.bool), x[1:] != x[:-1]])


def segment_facts(newseg, is_node_row, r_pred, r_head, mo_ind):
    """Per-node facts of the sorted rows, broadcast to every row of the
    node's segment (shared by stage_graph and the grouped tier's
    classification): three launches of kernel 2.

    newseg[i]: row i starts a segment (row 0 must); is_node_row: main
    rows; r_pred int32 predecessor code (7 on head rows); r_head: read
    heads; mo_ind: the row shows a second choice char or a tail window.
    Returns (seg_start int32, mo_row bool, mi_row bool, pred_single_row
    uint8): the segment's first row index, multi-out and multi-in on
    node rows, and the single predecessor base where there is one.

    All per-segment facts are PRESENCE tests evaluated at the
    segment-start rows; the six pack into one bit-word per row and ONE
    segmented suffix-OR."""
    R = newseg.shape[0]
    pred_bit = (torch.ones_like(r_pred) << r_pred) & 15
    bits = (
        torch.where(is_node_row, pred_bit, 0)
        | ((r_head & is_node_row).to(I32) << 4)
        | (mo_ind.to(I32) << 5)
    )
    stop = torch.cat([newseg[1:], newseg.new_ones(1)])
    orb = seg_suffix_or(bits | (stop.to(I32) << 6))
    del pred_bit, bits, stop
    p1 = (orb >> 1) & 1
    p2 = (orb >> 2) & 1
    p3 = (orb >> 3) & 1
    in_d = (orb & 1) + p1 + p2 + p3
    pred_sum = p1 + 2 * p2 + 3 * p3
    mo_seg = (orb & 32) != 0
    mi_seg = (in_d >= 2) | ((orb & 16) != 0)
    # only meaningful when in_d == 1; clamp to its 2-bit field (the sum
    # reaches 6 for multi-pred segments and would bleed into idx bits)
    pred_single = torch.where(in_d == 1, pred_sum, 0)
    facts = (pred_single << 2) | (mi_seg.to(I32) << 1) | mo_seg.to(I32)
    del orb, p1, p2, p3, in_d, pred_sum, mo_seg, mi_seg, pred_single
    # two prefix OR-carry scans broadcast (seg start row index, 4-bit
    # facts) from the start row to the whole segment; start rows carry
    # the stop bit, non-start rows carry 0 bits, so the OR-carry IS the
    # broadcast. Row indices fit below POS_STOP for all R < 2^29.
    idx = torch.arange(R, dtype=I32, device=newseg.device)
    stop_w = newseg.to(I32) << 29
    seg_start = seg_scan_or(
        torch.where(newseg, idx, 0) | stop_w, stop_bit=POS_STOP, prefix=True
    ) & (POS_STOP - 1)
    del idx
    f_row = seg_scan_or(
        torch.where(newseg, facts, 0) | stop_w, stop_bit=POS_STOP, prefix=True
    ) & 15
    del facts, stop_w
    mo_row = ((f_row & 1) != 0) & is_node_row
    mi_row = ((f_row & 2) != 0) & is_node_row
    pred_single_row = ((f_row >> 2) & 3).to(U8)
    return seg_start, mo_row, mi_row, pred_single_row


def fill_chars(is_spec, spec_char_row, mi_row, pred_single_row):
    """The BWT char a sorted row gets before the blue fill: a special
    row its own char, a multi-in row 0 (filled later), any other node
    row its node's single predecessor base."""
    return torch.where(
        is_spec, spec_char_row, pred_single_row.masked_fill(mi_row, 0)
    )


def stage_graph(
    x2p,              # uint8[N + constants.TAIL_PAD] codes (seps as
                      # T), T from n_real on
    sep_pos,          # int32[n_cap] separator positions (pad: >= N)
    spec_key,         # int64[n_spec_cap] T-filled special keys, true
                      # order; padding rows carry -1 (all ones)
    spec_char6,       # uint8[n_spec_cap]
    spec_branch_pos,  # int32[S_cap] special-branch positions (pad >= N)
    n_real: int,      # true text length (N is the bucket)
    m: int,
    N: int,
):
    dev = x2p.device
    k = m - 1
    is_sep = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    is_sep[sep_pos.clamp(max=N).to(I64)] = True
    is_sep = is_sep[:N]
    dist = _dist_from_sep(is_sep, N)
    pos = torch.arange(N, dtype=I32, device=dev)
    is_main = (dist >= k) & (pos < n_real)
    is_head = _shift_in(is_sep, True)
    is_tailw = dist == k
    # predecessor chars: a shift, never a gather
    prev = _shift_in(x2p[:N], 0)
    bwt_char = prev.masked_fill(is_head, 4).masked_fill(pos == 0, 5)
    n_spec = spec_key.shape[0]
    R = N + n_spec
    assert R < BIG, R
    # spec_ord = spec_j<<3 | char must stay below BIG even when n_spec
    # approaches N (degenerate read length ~= k)
    assert 8 * n_spec < BIG, n_spec
    spec_pad = spec_key == -1
    spec_j = torch.arange(n_spec, dtype=I32, device=dev)
    predf = prev.masked_fill(is_head, 7)

    # ---- the ONE sort: m-window keys, class+pos in ord ----
    # The m-window key IS (node key << 2 | next text char), so the sort
    # groups by node AND by real choice char for free. Keys are flipped
    # into signed order; only equality and the low 2 bits are read
    # after the sort, so they stay flipped.
    wkey = ops.window_keys(x2p[: N + m - 1], m)
    r_key = torch.cat([
        torch.where(is_main, wkey, -1),
        (spec_key << 2) | 3,           # spec62<<2 | T-fill; pads stay -1
    ]) ^ ops.SIGN
    ord_main = torch.where(is_main, pos - BIG, BIG + pos)
    ord_spec = torch.where(
        spec_pad, BIG + N + spec_j, (spec_j << 3) | spec_char6.to(I32)
    )
    r_ord = torch.cat([ord_main, ord_spec])
    f8_main = (
        (is_tailw.to(U8) << 4) | (is_head.to(U8) << 3) | predf
    ).masked_fill(~is_main, 0)
    f8 = torch.cat([f8_main, torch.zeros(n_spec, dtype=U8, device=dev)])
    r_key, r_ord, r_f8 = ops.msort((r_key, r_ord, f8), num_keys=2)
    del wkey, ord_main, ord_spec, f8, f8_main
    is_node_row = r_ord < 0
    is_spec1 = (r_ord >= 0) & (r_ord < BIG)
    row_valid = r_ord < BIG
    r_pred = (r_f8 & 7).to(I32)
    r_head = (r_f8 & 8) != 0
    r_tailw = (r_f8 & 16) != 0
    spec_char_row = (r_ord & 7).to(U8)         # spec rows only
    r_pos = r_ord + BIG                        # node rows only
    cls = torch.where(is_node_row, 0, torch.where(is_spec1, 1, 2))
    newseg = _changed(r_key >> 2) | _changed(cls)
    newseg[0] = True
    choice = r_key & 3
    mo_ind = ((_changed(choice) & ~newseg) | r_tailw) & is_node_row

    # main rows + spec rows == n_real exactly (they partition the
    # text); non-main and bucket-padding rows sort to the tail, so valid
    # sorted rows occupy [0, n_real) and the sorted row index IS the BWT
    # coordinate.
    seg_start, mo_row, mi_row, pred_single_row = segment_facts(
        newseg, is_node_row, r_pred, r_head, mo_ind
    )
    # SP event keys: pos<<3 | char6, one per multi-out row. The SP char
    # is the base k ahead (src/generateSP.c:626-651) — the m-window's
    # last char (key & 3), or '#'/'$' for tail windows. Positions are
    # unique, so sorting these keys yields the SP stream in text order
    # with the char riding along. SENT sorts pads to the tail and
    # decodes to pos 2^29-1 >= any bucket cap.
    is_dollar_row = r_tailw & (r_pos + (m - 1) == n_real - 1)
    sp6_row = torch.where(
        r_tailw, torch.where(is_dollar_row, 5, 4).to(I64), choice
    )
    ev_key = torch.where(mo_row, (r_pos.to(I64) << 3) | sp6_row, SENT)
    fill_row = fill_chars(is_spec1, spec_char_row, mi_row, pred_single_row)
    L = mo_row.sum() + (spec_branch_pos < n_real).sum()
    B = mi_row.sum()

    # partial BWT: case-2 runs + specials in place; case-3 slots zeroed
    bwt6_partial = fill_row.masked_fill(~row_valid, 0)[:N]
    r_pos_node = torch.where(is_node_row, r_pos, N)
    return (
        bwt6_partial, ev_key, mi_row, seg_start, r_pos_node,
        bwt_char, L, B, x2p,
    )


def stage_finish(
    x2p, ev_key, mi_row, seg_start, r_pos, bwt_char,
    bwt6_partial, spec_branch_pos, n_real: int,
    m: int, N: int, L_cap: int, B_cap: int,
):
    """The finished 6-letter BWT (uint8[N], the rows past n_real 0):
    the SP stream ranked by prefix tripling, the blue entries sorted by
    (node, rank) and scattered into bwt6_partial. Its three parts are
    the spans finish.sp (the SP sort and the wait for its length),
    finish.rank (_suffix_ranks) and finish.blue (the blue sorts and the
    scatter); none of them adds a wait."""
    dev = x2p.device
    k = m - 1

    with tracing.span("finish.sp"):
        with tracing.span("finish.enqueue"):
            # SP stream: node events arrive as ready-made pos<<3|char keys
            # from stage_graph; special-branch events get the same packing
            # here — their SP char is the raw text char k ahead (special
            # positions have dist < k, so the separator-tail branch never
            # applies). One sort yields the SP stream in text order with
            # the char in the low bits.
            brv = spec_branch_pos < n_real
            br = torch.where(brv, spec_branch_pos, N).to(I64)
            br_c = x2p[(br + k).clamp(max=x2p.shape[0] - 1)].to(I64)
            br_key = torch.where(brv, (br << 3) | br_c, SENT)
            allk = torch.cat([ev_key, br_key])
            if allk.shape[0] < L_cap:    # caps can exceed R on tiny inputs
                allk = torch.cat([
                    allk, torch.full((L_cap - allk.shape[0],), SENT,
                                     dtype=I64, device=dev)
                ])
            key_s = torch.sort(allk).values[:L_cap]
            sp_pos = (key_s >> 3).to(I32)    # SENT>>3 = 2^29-1 >= any cap
            sp6 = torch.where(sp_pos < N, (key_s & 7).to(U8), 0)
        # suffix ranks over the true length (end of string sorts below
        # every char), so the rank loop ends in O(log max-tie) rounds
        L_dyn = tracing.wait("finish", lambda: int((sp_pos < N).sum()))
    with tracing.span("finish.rank"):
        rank = _suffix_ranks(sp6, L_dyn)
    with tracing.span("finish.blue"), tracing.span("finish.enqueue"):
        # blue entries straight from row space. Pad rows share key N and
        # carry payload N, so their order is inert.
        bk = torch.where(mi_row, r_pos, N)
        sg = torch.where(mi_row, seg_start, N)
        if bk.shape[0] < B_cap:          # caps can exceed R on tiny inputs
            pad = torch.full((B_cap - bk.shape[0],), N, dtype=I32, device=dev)
            bk = torch.cat([bk, pad])
            sg = torch.cat([sg, pad])
        bp, b_base = ops.msort((bk, sg), num_keys=1)
        bp, b_base = bp[:B_cap], b_base[:B_cap]
        b_base = torch.where(bp < N, b_base, N)
        bpc = bp.clamp(max=N - 1)
        # sp index of a position = #SP events strictly before it, by
        # merged-sort counting: events keyed 2p+1 sort AFTER a query keyed
        # 2p, so an event AT the query position is not counted
        keys2 = torch.cat([sp_pos.clamp(max=N) * 2 + 1, bp * 2])
        pay = torch.cat([
            torch.full((L_cap,), -1, dtype=I32, device=dev),
            torch.arange(B_cap, dtype=I32, device=dev),
        ])
        _k_s, p_s = ops.msort((keys2, pay), num_keys=1)
        is_ev = (p_s < 0).to(I32)
        before = torch.cumsum(is_ev, 0, dtype=I32) - is_ev
        sp_idx = torch.zeros(B_cap + 1, dtype=I32, device=dev)
        sp_idx[torch.where(p_s >= 0, p_s, B_cap).to(I64)] = before   # B_cap: dropped
        b_rank = rank[sp_idx[:B_cap].clamp(max=L_cap - 1).to(I64)]
        # key3 = bp<<3 | bwt_char keeps equal-(block, rank) entries in
        # ascending-position order (the reference's queue-drain discipline,
        # src/generateSP.c:662-680) while the char rides the key
        b_pc = (bp.to(I64) << 3) | bwt_char[bpc.to(I64)].to(I64)
        base_s, _r, pc_s = ops.msort((b_base, b_rank, b_pc), num_keys=3)
        char_s = (pc_s & 7).to(U8)
        idx = torch.arange(B_cap, dtype=I32, device=dev)
        first = _changed(base_s)
        first[0] = True
        within = idx - torch.cummax(torch.where(first, idx, -1), 0).values
        tgt = torch.where(base_s < N, base_s + within, N).clamp(max=N)
        bwt6 = torch.cat([bwt6_partial, bwt6_partial.new_zeros(1)])
        bwt6[tgt.to(I64)] = char_s                                    # N: dropped
        return bwt6[:N]


def _suffix_ranks(sp6: torch.Tensor, L_dyn: int,
                  stage: str = "finish") -> torch.Tensor:
    """Suffix ranks of sp6[0:L_dyn] by prefix TRIPLING (each round sorts
    on (rank[i], rank[i+h], rank[i+2h]), covering prefix 3h), one host
    sync per round to stop as soon as all ranks are distinct. Rounds
    are traced as the spans <stage>.enqueue and <stage>.wait.

    Ranks are order-encodings, not dense: round 0 packs 10 biased chars
    (0 = past-end sentinel, 1..6 = chars, 3 bits each = 30 bits) into
    one int32, so the loop starts at h=10. Capacity-pad rows
    (i >= L_dyn) get distinct negative ranks so they never stall the
    all-distinct exit, and every lookahead past L_dyn reads -1, so
    rounds scale with the longest repeated substring of the SP string,
    not with the capacity: after r rounds prefixes of 10 * 3^r events
    are compared, so a repeat of length l takes about log3(l / 10) + 1
    rounds. One genome with exact repeats (the benchmark's dmel_140:
    about 44 k events in 140 Mbp) takes 2; 50 near-identical genomes
    (salmonella50_243: 10.9 M events, 4.5% of 243 Mbp, whose copies
    repeat long runs of branch passages) take 4 or 5, each a sort of
    the whole SP string and one wait.
    """
    M = sp6.shape[0]
    dev = sp6.device
    H0 = 10
    with tracing.span(f"{stage}.enqueue"):
        idx = torch.arange(M, dtype=I32, device=dev)
        real = idx < L_dyn
        c = torch.where(real, sp6.to(I32) + 1, 0)
        c_pad = torch.cat([c, torch.zeros(H0, dtype=I32, device=dev)])
        rank = torch.zeros(M, dtype=I32, device=dev)
        for i in range(H0):                  # static slices, not gathers
            rank = (rank << 3) | c_pad[i : i + M]
        rank = torch.where(real, rank, idx - M)   # pads: distinct, negative

    def look(rank, step):
        out = torch.full((M,), -1, dtype=I32, device=dev)
        n = L_dyn - step
        if n > 0:
            out[:n] = rank[step : step + n]
        return out

    step = H0
    while step < M:
        with tracing.span(f"{stage}.enqueue"):
            r2 = look(rank, step)
            r3 = look(rank, 2 * step)
            r_s, r2_s, r3_s, i_s = ops.msort((rank, r2, r3, idx), num_keys=3)
            new = _changed(r_s) | _changed(r2_s) | _changed(r3_s)
            new[0] = True
            csum = torch.cumsum(new.to(I32), 0, dtype=I32)
            rank = torch.empty_like(rank)
            rank[i_s.to(I64)] = csum - 1
        step *= 3
        tracing.count("rank_rounds")
        if tracing.wait(stage, lambda: int(csum[-1])) == M:
            break
    return rank
