"""Out-of-core tier: so far only the back half that the grouped tier
borrows (the counterpart of the JAX package's oocore.py).

Ported: the SP-rank routine `_sp_ranks_host` (its single-device
branch) and `blue_coordinates`. The passes of the out-of-core tier
itself (chunk keys, bucket classification, the spill store,
checkpoints, the oversized-bucket fallback and `build_bwt_ooc`) and
the `OocConfig` that sets them are not ported yet and land in this
module.

Coordinates are int64 — the "split index" discipline of the JAX
module: global bases are added in int64, so bases past 2^32 are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from debwt_tpu_torch import ops
from debwt_tpu_torch.bluesort import sp_suffix_ranks
from debwt_tpu_torch.pipeline import _bucket


# Longest SP string ranked on one device (the JAX package's
# OocConfig.sp_cap default); past it the ranking is sharded over devices.
SP_CAP = 1 << 28


def _sp_ranks_host(sp6: np.ndarray, L: int, sp_cap: int, device,
                   say) -> np.ndarray:
    """Suffix ranks of sp6[:L] as a host int32 array.

    L <= sp_cap: single-device prefix tripling (engine path) on
    `device`, over the eighth-power bucket of L (not a power of two,
    which would pad every rank-round sort by up to 2x).
    L  > sp_cap: the JAX package block-shards the SP string over
    its device mesh; that belongs to the multi-device tier, which is
    not ported.
    """
    if L == 0:
        return np.empty(0, np.int32)
    if L > sp_cap:
        raise NotImplementedError(
            f"SP string ({L} events) exceeds the single-device rank cap "
            f"{sp_cap}; sharded SP ranking belongs to the "
            "multi-device tier, which is not ported yet"
        )
    ext = np.zeros(_bucket(L), dtype=np.uint8)
    ext[:L] = sp6
    return sp_suffix_ranks(torch.from_numpy(ext).to(device), L)[:L].cpu().numpy()


def blue_coordinates(b_base, b_pos, b_char, rank, sp_pos, device):
    """Final BWT coordinates of the case-3 (blue) entries: sort by
    (block base, SP-suffix rank, position) — position ascending for
    equal ranks is the reference's LIFO-queue drain discipline
    (src/generateSP.c:662-680) — then coordinate = base + index within
    the equal-base run. All arithmetic is int64: bases past 2^32 (the
    30 Gbp tier) are exact.

    Host arrays in, host arrays out (coords int64, chars), as in the
    JAX package; the searches and the three-key sort run in torch on
    `device` (the fused engine's blue sort, engine.stage_finish, on
    entries that come from the host)."""
    dev = torch.device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    base, pos = put(b_base, np.int64), put(b_pos, np.int64)
    L = sp_pos.shape[0]
    sp_idx = torch.searchsorted(put(sp_pos, np.int64), pos)
    b_rank = put(rank, rank.dtype)[sp_idx.clamp_(max=max(0, L - 1))]
    del sp_idx
    base_s, _rank_s, _pos_s, char_s = ops.msort(
        (base, b_rank, pos, put(b_char, b_char.dtype)), num_keys=3
    )
    del base, b_rank, pos, _rank_s, _pos_s
    idx = torch.arange(base_s.shape[0], dtype=torch.int64, device=dev)
    first = base_s.new_ones(base_s.shape, dtype=torch.bool)
    first[1:] = base_s[1:] != base_s[:-1]
    within = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    return (base_s + within).cpu().numpy(), char_s.cpu().numpy()
