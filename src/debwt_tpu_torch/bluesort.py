"""The back half the grouped, out-of-core and multi-device tiers share:
SP suffix ranks and the blue-entry order, on the device.

The reference sorts each case-3 block with a comparator-driven
quicksort whose comparisons walk the SP code 32 chars at a time with
separator collation (myQsort/cmpSP, src/sortBlue.c:109-280). The
comparator reduces to plain lexicographic order over the 6-letter SP
string (see model.py), so the entire per-block comparison sort is
replaced by ONE prefix-tripling rank computation over the SP string
(sp_ranks) — O(L log L) total, batched across every block at once —
followed by a single sort of the blue entries by (block base, rank,
position) (blue_order).

The SP string is zero-padded ('A', matching the reference's calloc'd
tail, src/generateSP.c:220-227); within-block comparisons are always
decided before the pad can matter (the '$' marker is unique).
"""

from __future__ import annotations

import numpy as np
import torch

from debwt_tpu_torch import ops
from debwt_tpu_torch.engine import _suffix_ranks
from debwt_tpu_torch.pipeline import _bucket, _pow2

# Longest SP string ranked on one device (OocConfig.sp_cap's default);
# past it the ranking is sharded over devices.
SP_CAP = 1 << 28


def sp_ranks(sp6, L: int, sp_cap: int, device,
             say, mesh=None) -> torch.Tensor:
    """Suffix ranks of sp6[:L] (uint8, a host array or a tensor) as an
    int32 tensor on `device`. Ranks are ORDER ENCODINGS (not dense):
    callers use them only as sort keys.

    L <= sp_cap: the engine's prefix-tripling rank loop on `device`
    (rounds traced as the spans rank.enqueue and rank.wait), over the
    eighth-power bucket of L (not a power of two, which would pad every
    rank-round sort by up to 2x); zero-tail and end-sentinel orderings
    coincide because 0 is the minimum char.
    L  > sp_cap: the ooc x dist composition. The SP string is
    block-sharded over `mesh` (a parallel.mesh.Mesh; every rank holds
    the whole string on the host and calls this together) and ranked
    by parallel/sprank's sample-sort prefix tripling, so no device
    holds the whole string; the ranks are then gathered to every
    rank.
    """
    if L == 0:
        return torch.empty(0, dtype=torch.int32, device=device)
    if L <= sp_cap:
        ext = torch.zeros(_bucket(L), dtype=torch.uint8, device=device)
        ext[:L] = torch.as_tensor(sp6[:L], device=device)
        return _suffix_ranks(ext, L, stage="rank")[:L]
    if isinstance(sp6, torch.Tensor):
        sp6 = sp6.cpu().numpy()
    if mesh is None or mesh.n < 2:
        raise NotImplementedError(
            f"SP string ({L} events) exceeds the single-device rank cap "
            f"{sp_cap} and no multi-device mesh was given; pass mesh= "
            "(build_bwt_ooc) or route via api.build"
        )
    from debwt_tpu_torch.parallel.collectives import all_gather_rows
    from debwt_tpu_torch.parallel.sprank import sp_ranks_sharded

    n, r = mesh.n, mesh.rank
    Pb = max(8, _pow2(-(-L // n)))   # round 0 reads an 8-char halo
    blk = np.zeros(Pb, dtype=np.uint8)
    part = sp6[r * Pb : min(L, (r + 1) * Pb)]
    blk[: part.shape[0]] = part
    rank_blk = sp_ranks_sharded(mesh, torch.from_numpy(blk).to(mesh.device), L)
    say(f"SP ranks: sharded over {n} devices (block {Pb})")
    return all_gather_rows(mesh, rank_blk)[:L].to(device)


def blue_order(b_base, b_pos, b_char, rank, sp_pos, device):
    """Final BWT coordinates of the case-3 (blue) entries: sort by
    (block base, SP-suffix rank, position) — position ascending for
    equal ranks is the reference's LIFO-queue drain discipline
    (src/generateSP.c:662-680) — then coordinate = base + index within
    the equal-base run. All arithmetic is int64: bases past 2^32 (the
    30 Gbp tier) are exact.

    Each argument a host array or a tensor; the results (coords int64,
    chars) are tensors on `device`."""
    dev = torch.device(device)

    def put(a, dtype=None):
        return torch.as_tensor(a, device=dev, dtype=dtype)

    base, pos = put(b_base, torch.int64), put(b_pos, torch.int64)
    L = sp_pos.shape[0]
    sp_idx = torch.searchsorted(put(sp_pos, torch.int64), pos)
    b_rank = put(rank)[sp_idx.clamp_(max=max(0, L - 1))]
    del sp_idx
    base_s, _rank_s, _pos_s, char_s = ops.msort(
        (base, b_rank, pos, put(b_char)), num_keys=3
    )
    del base, b_rank, pos, _rank_s, _pos_s
    idx = torch.arange(base_s.shape[0], dtype=torch.int64, device=dev)
    first = base_s.new_ones(base_s.shape, dtype=torch.bool)
    first[1:] = base_s[1:] != base_s[:-1]
    within = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    return base_s + within, char_s
