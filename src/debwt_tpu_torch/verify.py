"""BWT verification: sampled occ table + LF backward reconstruction.

Resurrects the reference's dead verification path (the occ build at
src/insertCase3.c:139-208 and the LF walk in src/LFsearch.c:49-235,
unreachable in release builds because insertCase3 exits first) as a
first-class library feature: `lf_verify` walks the BWT backwards via LF
mapping and checks that it reproduces the text exactly.

Memory discipline mirrors the reference's 1-in-32 occ sampling
(src/insertCase3.c:158-193): peak extra memory is the sampled table
(6 counters per `sample` positions, ~0.75 N bytes at sample=32) plus
O(1) per walk step — never a full N-sized LF permutation. Small inputs
(N < 2^27) take a fast path that does precompute the LF permutation,
since there the arrays are a few hundred MB at most and the walk is
~10x faster per step.

Host NumPy, as in the JAX package (this is its verify.py on the port's
own native binding). The walk itself runs in the native walker
(csrc/lf_walk.cpp, io/native.py), built at first use; the Python loops
below are what the tests hold it against.
"""

from __future__ import annotations

import numpy as np


# below this, precomputing the full LF permutation is cheap (< ~3 GB)
_FAST_N = 1 << 27


def build_occ(bwt6: np.ndarray, sample: int = 32):
    """Sampled occurrence table over ACGT (separators excluded from the
    counts, matching src/LFsearch.c:207-231 which skips separator Ts).
    Returns (occ[ceil(N/sample)+1, 4], C int64[4]); occ[j] counts each
    base in bwt6[: j*sample]. Built by _build_occ6."""
    occ6, counts = _build_occ6(bwt6, sample)
    C = np.zeros(4, dtype=np.int64)
    C[1:] = np.cumsum(counts[:4])[:-1]
    return occ6[:, :4], C


def _build_occ6(bwt6: np.ndarray, sample: int):
    """occ6[j, c] = #occurrences of c in bwt6[: j*sample], over the
    6-letter alphabet (A C G T # $), with the six totals beside it.
    uint32 when counts fit. Built by the native walker's library in one
    pass (3 Gbp in seconds); _build_occ6_numpy is what it is held to."""
    from debwt_tpu_torch.io import native

    dtype = np.uint32 if bwt6.shape[0] < 2**32 else np.int64
    if native.has_lf_walk():
        return native.occ6(np.ascontiguousarray(bwt6), sample, dtype)
    return _build_occ6_numpy(bwt6, sample, dtype)


def _build_occ6_numpy(bwt6: np.ndarray, sample: int, dtype):
    """The plain version of _build_occ6, in 2^20-row blocks: the
    transient is O(block), not O(N)."""
    n = bwt6.shape[0]
    n_s = (n + sample - 1) // sample
    occ6 = np.zeros((n_s + 1, 6), dtype=dtype)
    base = np.zeros(6, dtype=np.int64)
    CH = (1 << 20) // sample * sample or sample
    alpha = np.arange(6, dtype=bwt6.dtype)
    for b0 in range(0, n, CH):
        blk = bwt6[b0 : b0 + CH]
        cum = np.cumsum(blk[:, None] == alpha[None, :], axis=0,
                        dtype=np.int64)
        j0 = b0 // sample
        j1 = min(n_s, (b0 + blk.shape[0]) // sample)
        rows = np.arange(j0 + 1, j1 + 1) * sample - b0 - 1
        occ6[j0 + 1 : j1 + 1] = (cum[rows] + base).astype(dtype)
        base += cum[-1]
    occ6[n_s] = base.astype(dtype)  # cover the ragged tail
    return occ6, base


def lf_verify(result, coll, max_steps: int | None = None,
              sample: int = 32) -> bool:
    """Walk the BWT backwards from '$' and compare against the text.
    Returns True iff the reconstruction matches exactly.

    The walk is inherently sequential (i <- LF[i]); max_steps bounds it
    for large texts (verifying the last max_steps chars — every step
    exercises the occ/rank structure end-to-end); None walks the whole
    text, like the reference's dev-mode loop (src/LFsearch.c:49-166,
    cap 3.1e10). Peak extra memory is the sampled occ table
    (~24/sample bytes per char) except on small inputs, where a full
    LF permutation is cheaper and faster."""
    from debwt_tpu_torch.io import native

    bwt6 = np.ascontiguousarray(result.bwt6)
    n = bwt6.shape[0]
    steps = n if max_steps is None else min(n, max_steps)
    x6 = np.ascontiguousarray(coll.x6)
    i = np.int64(result.dollar_pos)

    if n < _FAST_N:
        counts = np.bincount(bwt6, minlength=6)
        cum = np.zeros(7, dtype=np.int64)
        np.cumsum(counts, out=cum[1:])
        order = np.argsort(bwt6, kind="stable")
        ranks = np.empty(n, dtype=np.int64)
        ranks[order] = np.arange(n, dtype=np.int64) - cum[bwt6[order]]
        lf = cum[bwt6] + ranks
        if native.has_lf_walk():
            return native.lf_walk(lf, bwt6, x6, steps, int(i)) == -1
        for pos in range(n - 1, n - 1 - steps, -1):
            if x6[pos] != bwt6[i]:
                return False
            i = lf[i]
        return True

    occ6, counts = _build_occ6(bwt6, sample)
    cum = np.zeros(7, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    if native.has_lf_walk():
        occ6 = np.ascontiguousarray(occ6)
        return native.lf_walk_occ(
            bwt6, x6, occ6, cum, sample, steps, int(i)
        ) == -1
    for pos in range(n - 1, n - 1 - steps, -1):
        c = bwt6[i]
        if x6[pos] != c:
            return False
        blk = int(i) // sample
        r = int(occ6[blk, c]) + int(
            np.count_nonzero(bwt6[blk * sample : i] == c)
        )
        i = cum[c] + r
    return True
