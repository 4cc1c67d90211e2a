"""Blue-block ordering via SP suffix ranks — on the device.

The reference sorts each case-3 block with a comparator-driven
quicksort whose comparisons walk the SP code 32 chars at a time with
separator collation (myQsort/cmpSP, src/sortBlue.c:109-280). The
comparator reduces to plain lexicographic order over the 6-letter SP
string (see model.py), so the entire per-block comparison sort is
replaced by ONE prefix-tripling rank computation over the SP string —
O(L log L) total, batched across every block at once — followed by a
single sort of the blue entries by (node, rank).

The SP string is zero-padded ('A', matching the reference's calloc'd
tail, src/generateSP.c:220-227); within-block comparisons are always
decided before the pad can matter (the '$' marker is unique).
"""

from __future__ import annotations

import torch


def sp_suffix_ranks(sp6_ext: torch.Tensor, L_dyn: int | None = None):
    """Ranks of all suffixes of sp6_ext (uint8[M], zero-padded past the
    true length) as ORDER ENCODINGS (not dense): callers use them only
    as sort keys. Delegates to the engine's prefix-tripling rank loop
    (true-length semantics, all-distinct early exit); zero-tail and
    end-sentinel orderings coincide because 0 is the minimum char
    (first nonzero real char wins, else the shorter suffix is
    smaller). Its rounds are traced as the spans rank.enqueue and
    rank.wait (tracing.py)."""
    from debwt_tpu_torch.engine import _suffix_ranks

    if L_dyn is None:
        L_dyn = sp6_ext.shape[0]
    return _suffix_ranks(sp6_ext, int(L_dyn), stage="rank")
