"""Multi-device BWT construction over a torch.distributed process group
(the PyTorch counterpart of the JAX package's parallel/dist.py, whose
docstring derives the method).

One process drives one device (parallel/mesh.py). Rank r holds text
positions [r*Ns, (r+1)*Ns) with an (m + pad)-wide forward halo, and owns
the key range between two sampled splitters, hence one contiguous
segment of the BWT. Stages, each a function of its own so that its
temporaries die before the next:

  S0  window keys of the shard (kernel 1, one launch) and each edge's
      two owners: the owner of its prefix node and of its suffix node
  S1  edges routed to their owners; node tables over the owned key
      range; the unit merge with the owned specials; local coordinates;
      each edge's node flags routed back to the position that sent it
      (the echo of the same exchange); the tail windows' flags by
      all_reduce
  S2  text-side classification: SP events and blue entries
  S2b blue entries routed to their node's owner; S2c the SP string
      re-blocked across the ranks
  SP  the SP string ranked sharded (parallel/sprank.py); blue entries
      fetch their ranks from the block owners (echo pattern)
  S3  blue entries ordered by (node, rank) and the segment assembled
  stitch: every rank gathers every segment and finishes the whole BWT
          (BwtResult.from_bwt6)

Exchanges send only real rows (collectives.route: uneven splits), so
no key value is reserved as a pad marker. The JAX tier marks pads with
the key pair (0xFFFFFFFF, 0xFFFFFFFF), which at m = 32 is also the edge
key of 32 consecutive 'T's; such edges are taken for pads there, and
the build fails. Every int64 is a real edge key here.

Split-index discipline, as in the JAX tier: device arrays hold
shard-LOCAL positions and rank-local int32 BWT coordinates; the source
rank of a routed row is implied by the exchange, and the int64 segment
bases exist only in the stitch. The bound is per shard (N/n < 2^31).
"""

from __future__ import annotations

import numpy as np
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import ops, tracing
from debwt_tpu_torch.parallel import collectives as C
from debwt_tpu_torch.parallel.mesh import Mesh, make_mesh
from debwt_tpu_torch.parallel.sprank import sp_ranks_sharded
from debwt_tpu_torch.pipeline import BwtResult, _pow2, expected_char_counts
from debwt_tpu_torch.special import build_special, key_of_window
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

I32, I64, U8 = torch.int32, torch.int64, torch.uint8
MASK62 = (1 << 62) - 1          # node keys: k <= 31 chars
NO_REF = (1 << 61) - 1          # no node reference: above every reference
BIAS = 1 << 31

# debug capture: set to a dict to stash this rank's per-stage arrays
DEBUG = None


def _top_chars(key: torch.Tensor, nbits: int, c: int) -> torch.Tensor:
    """The first c chars (top 2c bits) of an nbits-wide right-aligned
    key. The mask drops the sign bits an arithmetic shift brings in, so
    an m = 32 key with its top bit set reads as its unsigned bits."""
    return (key >> (nbits - 2 * c)) & ((1 << (2 * c)) - 1)


def _dest_split(key, nbits: int, splitters: torch.Tensor, c: int):
    """Owner rank of each key: the number of splitters <= its first c
    chars (c = min(16, k), so node keys and edge keys agree on the
    owner of a node)."""
    return torch.searchsorted(splitters, _top_chars(key, nbits, c),
                              right=True, out_int32=True)


def _usort(x: torch.Tensor) -> torch.Tensor:
    """x sorted in unsigned order (an m = 32 key may have its top bit set)."""
    return torch.sort(x ^ ops.SIGN).values ^ ops.SIGN


def _find(a: torch.Tensor, q: torch.Tensor):
    """(index, hit) of each q in the sorted, distinct a."""
    if a.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(q, dtype=torch.bool)
    idx = torch.searchsorted(a, q).clamp_(max=a.numel() - 1)
    return idx, a[idx] == q


def _take(vals: torch.Tensor, idx, hit, default):
    """vals[idx] where hit, else default (vals may be empty: a rank can
    own no key at all)."""
    if vals.numel() == 0:
        return torch.full(idx.shape, default, dtype=vals.dtype, device=idx.device)
    return torch.where(hit, vals[idx], default)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def _owned_range(lo: int, hi: int, Pb: int, n: int) -> list:
    """Rows of the global range [lo, hi) that fall in each block of Pb."""
    return [max(0, min(hi, (d + 1) * Pb) - max(lo, d * Pb)) for d in range(n)]


# ---------------------------------------------------------------------------
# host inputs of one rank
# ---------------------------------------------------------------------------


def _shard(coll: SequenceCollection, sp, mesh: Mesh, m: int, Ns: int):
    """This rank's device inputs: the text shard with its forward halo
    (uint8 codes, 'T'-padded past the text), the distance of each
    position to the next separator clamped to m + 1 (-1 past the text:
    never main, never special), the special-branch mask, and the char
    and separator flag just before the shard."""
    N, r, dev = coll.bwt_len, mesh.rank, mesh.device
    HALO = m + K.TAIL_PAD
    x2 = np.full(Ns + HALO, K.T, dtype=np.uint8)
    part = coll.x2[r * Ns : r * Ns + Ns + HALO]
    x2[: part.shape[0]] = part
    sep_d = torch.from_numpy(np.ascontiguousarray(coll.sep, dtype=np.int64)).to(dev)
    pos = r * Ns + torch.arange(Ns, dtype=I64, device=dev)
    nxt = torch.searchsorted(sep_d, pos).clamp_(max=coll.n_reads - 1)
    dist = torch.where(pos < N, (sep_d[nxt] - pos).clamp_(max=m + 1), -1).to(I32)
    del pos, nxt
    br = sp.spec_branch_pos.astype(np.int64) - r * Ns
    br = br[(br >= 0) & (br < Ns)]
    sbm = torch.zeros(Ns, dtype=torch.bool, device=dev)
    sbm[torch.from_numpy(br).to(dev)] = True
    p = r * Ns - 1
    prev_char = int(coll.x2[p]) if 0 <= p < N else 0
    prev_sep = 0 <= p < N and bool(np.isin(p, coll.sep))
    return torch.from_numpy(x2).to(dev), dist, sbm, sep_d, prev_char, prev_sep


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def _s0_edges(x2, dist, m: int, splitters, split_c: int):
    """Edge keys of the shard (one launch of kernel 1, on the uint8
    codes x2[: Ns + m - 1]), which are valid (dist >= m: the m-window
    holds no separator), and each edge's two owners. The suffix word
    (suffix node << 2 | first char) sorts, unsigned, by (suffix node,
    first char)."""
    k = m - 1
    Ns = dist.shape[0]
    e = ops.window_keys(x2[: Ns + m - 1], m)
    valid = dist >= m
    d1 = _dest_split(e, 2 * m, splitters, split_c)
    sk = e & ((1 << (2 * k)) - 1)
    d2 = _dest_split(sk, 2 * k, splitters, split_c)
    w2 = (sk << 2) | ((e >> (2 * k)) & 3)
    return e, valid, d1, d2, w2


def _s1_nodes(mesh: Mesh, x2, dist, m: int, tailq, heads, spec, spec_char,
              splitters, split_c: int):
    """S0, then route the edges to their owners, build the owned node
    table and the unit merge, answer each edge with its node's flags,
    and combine the tail windows' flags over the ranks."""
    n, r, k = mesh.n, mesh.rank, m - 1
    e, valid, d1, d2, w2 = _s0_edges(x2, dist, m, splitters, split_c)
    tracing.mark("S0 edge keys", mesh.device)
    # ---- prefix-routed edges (the echo below answers them) ----
    (e_in,), send1, recv1, sent_pos = C.route(mesh, d1, valid, e)
    del e, d1
    e_s = _usort(e_in)
    pk, occ = torch.unique_consecutive((e_s >> 2) & MASK62, return_counts=True)
    ue = torch.unique_consecutive(e_s)
    ext = torch.unique_consecutive((ue >> 2) & MASK62, return_counts=True)[1]
    del e_s, ue
    # ---- suffix-routed edges: distinct predecessor chars per node ----
    (w_in,), _, _, _ = C.route(mesh, d2, valid, w2)
    del d2, w2, valid
    uw = torch.unique_consecutive(_usort(w_in))
    del w_in
    sk2, in_seg = torch.unique_consecutive((uw >> 2) & MASK62, return_counts=True)
    pred_seg = (uw[_excl_cumsum(in_seg)] & 3).to(U8)
    del uw

    # ---- owned tails and heads; the node table ----
    th = torch.sort(tailq[_dest_split(tailq, 2 * k, splitters, split_c) == r]).values
    hh = heads[_dest_split(heads, 2 * k, splitters, split_c) == r]
    node = torch.unique(torch.cat([pk, th]))

    def join(a, vals, default):
        return _take(vals, *_find(a, node), default)

    tail_mult = (torch.searchsorted(th, node, right=True)
                 - torch.searchsorted(th, node))
    cnt = join(pk, occ, 0) + tail_mult
    multi_out = (join(pk, ext, 0) >= 2) | (tail_mult > 0)
    multi_in = (join(sk2, in_seg, 0) >= 2) | _find(hh, node)[1]
    pred = join(sk2, pred_seg, 0)
    del pk, occ, ext, sk2, in_seg, pred_seg, tail_mult

    # ---- units: nodes and owned specials in key order; a special
    # follows the node of its T-filled key, specials in their true
    # order (stable sort over [nodes, specials in order]) ----
    own = torch.nonzero(_dest_split(spec, 2 * k, splitters, split_c) == r)[:, 0]
    order = torch.sort(torch.cat([node, spec[own]]), stable=True).indices
    unit_size = torch.cat([cnt, torch.ones_like(own)])[order]
    unit_char = torch.cat([pred.masked_fill(multi_in, 0), spec_char[own]])[order]
    start = torch.empty_like(unit_size)
    start[order] = _excl_cumsum(unit_size)
    node_start = start[: node.shape[0]].to(I32)
    del order, start, pred

    # ---- each edge's flags back to the position that sent it ----
    nid = torch.searchsorted(node, (e_in >> 2) & MASK62)
    del e_in
    resp = ((nid * n + r) << 2) | (multi_in[nid].to(I64) << 1) | multi_out[nid].to(I64)
    del nid
    flags = C.a2a(mesh, resp, recv1, send1)
    del resp

    # ---- tail windows: their node's flags from its owner ----
    idx, hit = _find(node, tailq)
    tail_mi = C.psum(mesh, _take(multi_in, idx, hit, False).to(I32))
    tail_ref = C.pmin(mesh, torch.where(hit, idx * n + r, NO_REF))
    return dict(node=node, cnt=cnt, multi_in=multi_in, node_start=node_start,
                unit_size=unit_size, unit_char=unit_char, flags=flags,
                sent_pos=sent_pos, tail_mi=tail_mi, tail_ref=tail_ref)


def _s2_classify(mesh: Mesh, dist, sbm, sep_d, flags, sent_pos, tail_mi,
                 tail_ref, Ns: int, k: int):
    """Per position of the shard: its node's flags (ref << 2 | multi_in
    << 1 | multi_out, -1 where no edge starts), the SP events and the
    blue entries. A tail window (dist == k) is multi-out by definition;
    its multi-in and node come from the tail flags of its read."""
    word = torch.full((Ns,), -1, dtype=I64, device=dist.device)
    word[sent_pos] = flags
    tp = torch.nonzero(dist == k)[:, 0]
    rid = torch.searchsorted(sep_d, mesh.rank * Ns + tp)
    word[tp] = (tail_ref[rid] << 2) | ((tail_mi[rid] > 0).to(I64) << 1) | 1
    is_main = dist >= k
    is_sp = (is_main & (word >= 0) & ((word & 1) == 1)) | sbm
    is_blue = is_main & (word >= 0) & ((word & 2) == 2)
    return word, is_sp, is_blue


def _s2b_sp_blue(mesh: Mesh, x2, dist, word, is_sp, is_blue, prev_char: int,
                 prev_sep: bool, N: int, Ns: int, k: int):
    """The shard's SP chars (the char k ahead, or '#'/'$' at a tail
    window), every rank's SP count and their total, and the shard's blue
    entries routed to their node's owner as (node index, global SP index
    << 3 | BWT char)."""
    n, r = mesh.n, mesh.rank
    spi = torch.nonzero(is_sp)[:, 0]
    sp_base, L, l_sp = C.exclusive_scan_i32(mesh, spi.shape[0])
    dollar = (N - 1 - k) // Ns == r
    is_sepc = dist[spi] == k
    is_dollar = is_sepc & (spi == (N - 1 - k) % Ns) & dollar
    sp6 = torch.where(is_sepc, torch.where(is_dollar, 5, 4).to(U8),
                      x2[spi + k])
    bli = torch.nonzero(is_blue)[:, 0]
    sidx = (torch.searchsorted(spi, bli) + sp_base).to(I32)
    ref = word[bli] >> 2
    prev = (bli - 1).clamp(min=0)
    first = bli == 0
    pchar = torch.where(first, prev_char, x2[prev].to(I64))
    psep = torch.where(first, prev_sep, dist[prev] == 0)
    char6 = torch.where(psep, 4, pchar)
    if r == 0:
        char6 = char6.masked_fill(first, 5)
    msg = torch.stack([ref // n, (sidx.to(I64) << 3) | char6], dim=1)
    (blue,), _, _, _ = C.route(mesh, ref % n, None, msg)
    return sp6, l_sp, L, blue


def _s2c_reblock(mesh: Mesh, sp6, l_sp: list, L: int):
    """The SP string re-blocked: rank r gets global indices
    [r*Pb, (r+1)*Pb), 0 past L. Every rank knows every rank's count, so
    the split sizes need no exchange."""
    n, r = mesh.n, mesh.rank
    Pb = _pow2(max(16, -(-L // n)))
    bases = np.cumsum([0] + l_sp)
    send = _owned_range(int(bases[r]), int(bases[r + 1]), Pb, n)
    recv = [_owned_range(int(bases[s]), int(bases[s + 1]), Pb, n)[r]
            for s in range(n)]
    got = C.a2a(mesh, sp6, send, recv)
    blk = torch.zeros(Pb, dtype=U8, device=sp6.device)
    blk[: got.shape[0]] = got
    return blk, Pb


def _blue_ranks(mesh: Mesh, rank_blk, sidx, L: int, Pb: int):
    """SP ranks of the blue entries' SP indices: each query goes to the
    owner of its block, which answers in place (echo pattern)."""
    dest = sidx.to(I64).clamp(max=L - 1) // Pb
    (q,), send, recv, order = C.route(mesh, dest, None, sidx)
    local = (q.to(I64) - mesh.rank * Pb).clamp(0, rank_blk.shape[0] - 1)
    back = C.a2a(mesh, rank_blk[local], recv, send)
    out = torch.empty_like(back)
    out[order] = back
    return out


def _s3_assemble(node_start, unit_size, unit_char, nid, b_rank, b_char):
    """This rank's BWT segment: every unit's run (a node's single
    predecessor base, 0 where it is multi-in; a special's char), then
    the blue entries of each multi-in node in SP-rank order. (node, SP
    rank) pairs are distinct: two occurrences of one node with no SP
    event between them would close a cycle of single-successor nodes."""
    seg = torch.repeat_interleave(unit_char, unit_size)
    key = (nid << 32) | (b_rank.to(I64) + BIAS)
    key_s, perm = torch.sort(key)
    nid_s = key_s >> 32
    idx = torch.arange(nid_s.shape[0], device=nid_s.device)
    first = torch.ones_like(nid_s, dtype=torch.bool)
    first[1:] = nid_s[1:] != nid_s[:-1]
    within = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    seg[node_start[nid_s].to(I64) + within] = b_char[perm]
    return seg


@tracing.recorded
def dist_build_bwt(
    coll: SequenceCollection,
    config: PipelineConfig | None = None,
    mesh: Mesh | None = None,
) -> BwtResult:
    """The BWT of `coll` built by every rank of the mesh's process group
    together (each rank calls this with the same collection); every
    rank returns the whole result. mesh: parallel.make_mesh(); None
    makes one over the joined group (a one-rank group if none is
    joined) on the rank's CUDA card."""
    config = config or PipelineConfig()
    m, k = config.m, config.k
    mesh = mesh or make_mesh()
    n, r, dev = mesh.n, mesh.rank, mesh.device
    N = coll.bwt_len
    Ns = -(-N // n)
    if Ns + m + K.TAIL_PAD >= 2**31:
        raise NotImplementedError(
            f"per-shard text of {Ns} chars exceeds int32; use more "
            f"devices (N/n must stay below 2^31)"
        )
    sp = build_special(coll, m)
    split_c = min(16, k)
    splitters = torch.from_numpy(
        ops.sample_splitters(coll.x2, n, split_c, 17, 1 << 16).astype(np.int64)
    ).to(dev)

    def d64(a):
        return torch.from_numpy(np.asarray(a).view(np.int64)).to(dev)

    # tails in READ order (sp.tail_keys is sorted, with duplicates): the
    # flag of read j's tail window is looked up at index j
    tailq = d64(key_of_window(coll.x2, coll.sep - k, k))
    heads, spec = d64(sp.head_keys), d64(sp.spec_tfill)
    spec_char = torch.from_numpy(sp.spec_bwt6).to(dev)
    x2, dist, sbm, sep_d, prev_char, prev_sep = _shard(coll, sp, mesh, m, Ns)
    tracing.mark("host inputs", dev)

    s1 = _s1_nodes(mesh, x2, dist, m, tailq, heads, spec, spec_char,
                   splitters, split_c)
    tracing.mark("S1 node tables", dev)
    word, is_sp, is_blue = _s2_classify(
        mesh, dist, sbm, sep_d, s1.pop("flags"), s1.pop("sent_pos"),
        s1.pop("tail_mi"), s1.pop("tail_ref"), Ns, k)
    tracing.mark("S2 classification", dev)
    sp6, l_sp, L, blue = _s2b_sp_blue(
        mesh, x2, dist, word, is_sp, is_blue, prev_char, prev_sep, N, Ns, k)
    del word
    sp6_blk, Pb = _s2c_reblock(mesh, sp6, l_sp, L)
    del sp6
    tracing.mark("S2b/c SP + blue routing", dev)
    rank_blk = sp_ranks_sharded(mesh, sp6_blk, L)
    b_sidx = (blue[:, 1] >> 3).to(I32)
    b_rank = _blue_ranks(mesh, rank_blk, b_sidx, L, Pb)
    tracing.mark("SP rank", dev)
    seg = _s3_assemble(s1["node_start"], s1["unit_size"], s1["unit_char"],
                       blue[:, 0], b_rank, (blue[:, 1] & 7).to(U8))
    tracing.mark("S3 assembly", dev)
    if DEBUG is not None:
        host = lambda t: t.cpu().numpy()  # noqa: E731
        DEBUG.update(
            node=host(s1["node"]), cnt=host(s1["cnt"]),
            node_start=host(s1["node_start"]), multi_in=host(s1["multi_in"]),
            is_sp=host(is_sp), is_blue=host(is_blue), b_sidx=host(b_sidx),
            b_rank=host(b_rank), sp6_blk=host(sp6_blk), sharded_rank=True,
        )
    del s1, is_sp, is_blue, blue, b_rank, rank_blk, sp6_blk

    bwt6 = C.all_gather_rows(mesh, seg)
    del seg
    if bwt6.shape[0] != N:
        raise AssertionError(f"stitched BWT has {bwt6.shape[0]} chars, want {N}")
    result = BwtResult.from_bwt6(
        bwt6, coll.n_reads,
        expected_char_counts(coll) if config.check else None)
    del bwt6
    tracing.mark("stitch", dev)
    return result
