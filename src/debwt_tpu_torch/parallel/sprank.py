"""Sharded SP suffix ranking: sample-sort prefix tripling (the PyTorch
counterpart of the JAX package's parallel/sprank.py, whose docstring
derives the method).

The SP string and its rank array stay block-sharded over the ranks: rank
r holds global indices [r*Pb, (r+1)*Pb). Each round covers prefix 3h:

  1. lookaheads rank[i+h], rank[i+2h]: h is a host integer, so the
     blocks r+q and r+q+1 (q = h // Pb) arrive by direct P2P (the JAX
     version needs log2(n) conditional hops only because its h is
     traced);
  2. a global sort of the (rank, rank+h, rank+2h, idx) tuples as a
     sample sort: local sort, splitters from an all-gathered sample,
     routing by splitter range, local re-sort (the trailing idx makes
     every key unique, so ties never unbalance the partitions);
  3. dense re-ranking, with each partition's first and last tuple
     all-gathered so that a run crossing ranks is not split;
  4. the new ranks travel home as the echo of step 2's exchange: every
     row a rank routed out was one of its own block's, so the echo
     lands each rank's ranks at their owner.

The host waits twice a round: for the routing's split sizes and for
the gathered partition summaries, which carry the all-distinct flag.
The exchanges take uneven split sizes, so no partition has a capacity
to overflow (the JAX version routes into padded slots of slack * Pb
rows and retries with more slack): a skewed sample only makes a rank
receive more rows, never more than the n * Pb of the whole string.
"""

from __future__ import annotations

import torch

from debwt_tpu_torch import ops
from debwt_tpu_torch.parallel import collectives as C
from debwt_tpu_torch.parallel.mesh import Mesh

I32 = torch.int32
I64 = torch.int64
HALO = 8          # chars packed into the round-0 rank (3 bits each)
BIAS = 1 << 31


def _shift_left(mesh: Mesh, blk: torch.Tensor, h: int, L: int, fill) -> torch.Tensor:
    """out[j] = global blk[gi[j] + h], or `fill` where gi + h >= L: the
    tail of block r+q and the head of block r+q+1 (q = h // Pb), each
    sent by its owner straight to this rank."""
    Pb, r, n = blk.shape[0], mesh.rank, mesh.n
    q, off = divmod(h, Pb)
    out = torch.full_like(blk, fill)
    sends, recvs = [], []
    if r - q >= 0:
        sends.append((r - q, blk[off:]))
    if off and r - q - 1 >= 0:
        sends.append((r - q - 1, blk[:off]))
    if r + q < n:
        recvs.append((r + q, out[: Pb - off]))
    if off and r + q + 1 < n:
        recvs.append((r + q + 1, out[Pb - off :]))
    C.p2p(mesh, sends, recvs)
    gi = r * Pb + torch.arange(Pb, dtype=I64, device=blk.device)
    return out.masked_fill_(gi + h >= L, fill)


def _round0(mesh: Mesh, sp6_blk: torch.Tensor, L: int) -> torch.Tensor:
    """Ranks of the 8-char prefixes (chars biased by one, 0 past the
    end), with the next block's first 8 chars as the halo; pad rows get
    distinct negative ranks."""
    Pb, r = sp6_blk.shape[0], mesh.rank
    dev = sp6_blk.device
    halo = torch.zeros(HALO, dtype=sp6_blk.dtype, device=dev)
    C.p2p(mesh, [(r - 1, sp6_blk[:HALO])] if r else [],
          [(r + 1, halo)] if r + 1 < mesh.n else [])
    ext = torch.cat([sp6_blk, halo]).to(I32)
    gi_ext = r * Pb + torch.arange(Pb + HALO, dtype=I64, device=dev)
    c = torch.where(gi_ext < L, ext + 1, 0)
    rank = torch.zeros(Pb, dtype=I32, device=dev)
    for j in range(HALO):
        rank = (rank << 3) | c[j : j + Pb]
    gi = gi_ext[:Pb]
    return torch.where(gi < L, rank, (gi - mesh.n * Pb).to(I32))


def _pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 word whose order is the lexicographic order of two
    int32 keys (hi high, lo biased by 2^31 low)."""
    return (hi.to(I64) << 32) | (lo.to(I64) + BIAS)


def _round(mesh: Mesh, rank: torch.Tensor, h: int, L: int, n_samp: int):
    """One tripling round: (new block ranks, all distinct)."""
    Pb, r, n = rank.shape[0], mesh.rank, mesh.n
    dev = rank.device
    gi = r * Pb + torch.arange(Pb, dtype=I32, device=dev)
    r2 = _shift_left(mesh, rank, h, L, -1)
    r3 = _shift_left(mesh, rank, 2 * h, L, -1)
    a, b = _pair(rank, r2), _pair(r3, gi)
    del r2, r3
    a, b = ops.msort((a, b), num_keys=2)
    loc = ((b & 0xFFFFFFFF) - BIAS - r * Pb).to(I64)   # block index of each

    # splitters: equal-depth over the all-gathered sample of sorted keys
    sidx = ((torch.arange(n_samp, device=dev) + 1) * Pb) // (n_samp + 1)
    alls = C.all_gather(mesh, torch.stack([a[sidx], b[sidx]], dim=1))
    alls = alls.reshape(n * n_samp, 2)
    sa, sb = ops.msort((alls[:, 0], alls[:, 1]), num_keys=2)
    spl = ((torch.arange(n - 1, device=dev) + 1) * (n * n_samp)) // n
    pa, pb = sa[spl], sb[spl]

    # destination = number of splitters below the key; the keys are
    # sorted, so destinations ascend and the rows are already grouped
    dest = torch.zeros(Pb, dtype=I64, device=dev)
    for i in range(n - 1):
        dest += ((a > pa[i]) | ((a == pa[i]) & (b > pb[i]))).to(I64)
    send = torch.bincount(dest, minlength=n).tolist()
    recv = C.exchange_counts(mesh, send)
    got = C.a2a(mesh, torch.stack([a, b], dim=1), send, recv)
    del a, b, dest
    qa, qb, perm = ops.msort(
        (got[:, 0], got[:, 1], torch.arange(got.shape[0], device=dev)),
        num_keys=2,
    )
    del got
    q3 = qb >> 32                      # (q1, q2) is qa; q3 the high half of qb
    n_real = qa.shape[0]
    new = torch.ones(n_real, dtype=torch.bool, device=dev)
    if n_real:
        new[1:] = (qa[1:] != qa[:-1]) | (q3[1:] != q3[:-1])
        ends = [int(qa[0]), int(q3[0]), int(qa[-1]), int(q3[-1])]
    else:
        ends = [0, 0, 0, 0]
    interior = int(new[1:].sum()) if n_real else 0

    # partition summaries: first/last tuple, size, interior run starts
    summ = C.all_gather_ints(mesh, [n_real, *ends, interior])
    prev = None                        # last tuple of the last non-empty rank
    base = total = 0
    for s, (cnt, fa, f3, la, l3, inner) in enumerate(summ):
        if not cnt:
            continue
        first_new = prev is None or (fa, f3) != prev
        if s == r and n_real:
            new[0] = first_new
            base = total
        total += inner + int(first_new)
        prev = (la, l3)
    nrank = (base + torch.cumsum(new.to(I32), 0, dtype=I32) - 1)
    done = total == n * Pb

    # the echo: ranks back in received order, then home (in the order
    # this rank sent, which is its sorted local order)
    resp = torch.empty_like(nrank)
    resp[perm] = nrank
    back = C.a2a(mesh, resp, recv, send)
    rank_new = torch.empty(Pb, dtype=I32, device=dev)
    rank_new[loc] = back
    return rank_new, done


def sp_ranks_sharded(mesh: Mesh, sp6_blk: torch.Tensor, L: int) -> torch.Tensor:
    """Suffix ranks (order encodings) of the block-sharded SP string.

    sp6_blk: this rank's (Pb,) uint8 block on mesh.device; entries at
    global index >= L are ignored. Returns this rank's (Pb,) int32
    ranks."""
    n = mesh.n
    Pb = int(sp6_blk.shape[0])
    assert n * Pb >= L and Pb >= HALO, (n, Pb, L)
    rank = _round0(mesh, sp6_blk, L)
    n_samp = min(Pb, 1024)
    h = HALO
    while h < n * Pb:
        rank, done = _round(mesh, rank, h, L, n_samp)
        if done:
            break
        h *= 3
    return rank
