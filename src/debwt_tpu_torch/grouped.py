"""Device-resident grouped engine — the single-card tier for collections
over the fused engine's row bound (the PyTorch counterpart of the JAX
package's grouped.py).

The fused engine (engine.py) sorts all N rows at once, so the card's
memory and the 2^29-row scan bound cap it (api.single_rows_bound). This
tier bounds device memory by a middle path that never ships keys to the
host:

  * the 2-bit packed text stays resident on the device (N / 4 bytes);
  * the key space is cut into G groups by sampled equal-depth
    splitters on full 62-bit node keys (the balance role of the
    reference's bucket histograms, src/mySort.c:98-110, at maximal
    depth — any hot shared prefix can be split);
  * per group, the text is scanned chunk by chunk: every row is
    re-derived from the packed text (window keys by kernel 1, the
    distance to the next separator by kernel 2) and the rows whose node
    keys fall in the group's range are copied, by a mask, into a
    bounded device buffer;
  * the engine's one-sort classification (same row semantics as
    engine.stage_graph, reference mergeKmer src/INandOut.c:252-445)
    then runs on the group's rows. Groups are processed in ascending
    key order, so the sorted row index plus the running base IS the
    global BWT coordinate;
  * each group's 2-bit fill characters stay on the device, in one
    buffer of N / 4 bytes allocated before the passes (so that every
    group's transients fit where the last group's were); its SP event
    positions and blue entries (branch events only — tiny next to the
    text) are compacted there and fetched. The back half is the
    out-of-core tier's on the device: its SP string (_sp_string, from
    the packed text), oocore.sp_ranks and oocore.blue_order; the BWT,
    its '#'/'$' sidecars and packed words are made there, as the fused
    engine makes them, so that only the words and the sidecars cross
    back.

The text crosses once, as its uint8 codes, and is packed on the
device (ops.pack_text). Stages are tracing.py spans (grouped.special, .text, .groups
with .select / .classify / .rows a group, .sp, .fill); the host blocks
on the device only in tracing.wait.

Representation, against the JAX module's (hi, lo) uint32 pairs and
uint32 positions (torch has no uint32 arithmetic on the CPU):

  key   one int64 holding the 64 bits of (hi << 32) | lo. The 62-bit
        node key is the logical key >> 2, a non-negative int64, so the
        range test against the splitters is a plain comparison. At
        m = 32 the window fills all 64 bits: a key is flipped at the
        top bit (ops.SIGN) before the signed sort.
  ord   int32, the JAX uint32 value less 2^31 (ORD_BIAS), which keeps
        the order: a main row's position p rides as p - 2^31, a special
        row as ORD_SPEC + j - 2^31, a pad row as 2^31 - 1. It costs 4
        bytes a row in the group buffer and in the sort, where an int64
        with the JAX values unchanged would cost 8; the price is one
        add where positions leave the device (they are int64 on the
        host). MAX_N stays the JAX package's, so that both packages
        route the same collection the same way.

The per-group re-scan of the text (G scans in all) is kept from the JAX
tier; a single binning pass is a later option.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import engine, ops, tracing
from debwt_tpu_torch.kernels.seg_or import seg_scan_or
from debwt_tpu_torch.kernels.window_keys import window_keys as _wk_counter
from debwt_tpu_torch.pipeline import BwtResult, _bucket, _pow2, resolve_device
from debwt_tpu_torch.special import build_special
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8
POS_STOP = 1 << 29
MASK62 = (1 << 62) - 1

# row classes of the third sort operand, as the JAX module's uint32:
#   main row:   global position            (< ORD_SPEC)
#   special:    ORD_SPEC | global spec_j   (spec_j < 2^28)
#   pad:        0xFFFFFFFF
ORD_SPEC = 0xE0000000
ORD_PAD = 0xF0000000
ORD_BIAS = 1 << 31          # the port's int32 ord = JAX ord - ORD_BIAS
PAD_ORD = 0xFFFFFFFF - ORD_BIAS
# hard ceiling on N for this tier (positions below ORD_SPEC)
MAX_N = ORD_SPEC
# R = cap + ns_cap < 2^29: the classification's scans pack a row index
# under the stop bit
SCAN_ROWS = 1 << 29

# Device bytes the default cap is sized by on a CUDA device, both read
# on an NVIDIA H100 80GB HBM3 at 700 W (see PERF.md): the caching
# allocator's reserved peak of a whole build through api.build with the
# check on, over the rows of its largest group (R = cap_run + ns_cap),
# was 129.65 at R = 41,943,104 (140 Mbp in 4 groups, with the text and
# the BWT on the host), and with the fills, BWT and pack on the card
# 106.52 at R = 402,653,312 (600 Mbp in 2 groups) and 103.38 at R =
# 536,870,908, the scan bound (3 Gbp in 7 groups); the largest, rounded
# up. What stays resident through the passes, N / 2 bytes, is budgeted
# apart (default_cap). A text position of one
# selection chunk costs the chunk's transients (keys, node keys, scan
# words, masks, the compaction's indices): 40.1 bytes at a chunk of
# 2^27 (the allocator's peak when the first selection ended, less the
# text and the group buffers), held here with headroom.
_GROUP_BYTES_PER_ROW = 130
_SELECT_BYTES_PER_POS = 64

# target group fill fraction (slack for splitter sampling error; an
# overflow is detected and retried with more groups)
_FILL = 0.85

@dataclasses.dataclass(frozen=True)
class GroupedConfig:
    """Knobs for the grouped device-resident tier.

    cap:     rows per group buffer; with the special rows of a group it
             is what the classification sorts at once. None: what the
             device holds (default_cap), or the DEBWT_GROUPED_CAP
             environment variable (read per build) where that is less.
    chunk:   text positions per selection step inside the group scan.
    """

    cap: int | None = None
    chunk: int = 1 << 27

    def resolved_cap(self, dev: torch.device, n: int, chunk: int) -> int:
        """The cap a build of n positions in chunks of `chunk` starts
        from on `dev`: an explicit cap as given, else default_cap, which
        DEBWT_GROUPED_CAP can lower but never raise."""
        if self.cap is not None:
            return self.cap
        cap = default_cap(dev, n, chunk)
        env = os.environ.get("DEBWT_GROUPED_CAP")
        return cap if env is None else min(cap, int(env))


def default_cap(dev: torch.device, n: int, chunk: int) -> int:
    """Rows a group may hold on `dev` for a text of n positions scanned
    in chunks of `chunk`: under the scan bound, and on a CUDA device
    what the free memory holds beside what stays resident through the
    passes (the packed text and the groups' 2-bit fills, n / 4 bytes
    each) and one chunk's selection transients. The CPU is bound by the
    scans alone."""
    cap = SCAN_ROWS - 4
    if dev.type == "cuda":
        from debwt_tpu_torch.api import _device_memory_bytes

        free = _device_memory_bytes(dev) - n // 2 - chunk * _SELECT_BYTES_PER_POS
        cap = min(cap, free // _GROUP_BYTES_PER_ROW)
        if cap < 1024:
            raise RuntimeError(
                f"the grouped tier needs more device memory than {dev} has "
                f"free for a text of {n} positions"
            )
    return cap


class GroupOverflow(RuntimeError):
    pass


def sample_splitters64(x2: np.ndarray, n: int, k: int, seed: int = 17,
                       samples: int = 1 << 18) -> np.ndarray:
    """n-1 equal-depth uint64 splitters over full k-char node keys
    (the balance role of mySort's cumulative bucket counts,
    src/mySort.c:104-110, at maximal depth). Same seed and sample count
    as the JAX package, so both plan the same groups."""
    P = max(1, x2.shape[0] - k)
    idx = np.random.default_rng(seed).integers(0, P, size=samples)
    v = np.zeros(samples, dtype=np.uint64)
    for i in range(k):
        v = (v << np.uint64(2)) | x2[
            np.minimum(idx + i, x2.shape[0] - 1)
        ].astype(np.uint64)
    v.sort()
    qs = (np.arange(1, n) * samples) // n
    return v[qs]


def _chunk_seps(sep: np.ndarray, dev, C: int, n_chunks: int, k: int):
    """The separator positions (host int64, ascending) on `dev`, and
    for each text chunk the view of them that _chunk_rows reads: those
    in [c0 - 1, c0 + C + k + 1), c0 the chunk's first position."""
    sep_d = torch.from_numpy(sep).to(dev)
    c0 = np.arange(n_chunks, dtype=np.int64) * C
    a = np.searchsorted(sep, c0 - 1).tolist()
    b = np.searchsorted(sep, c0 + C + k + 1).tolist()
    return sep_d, [sep_d[i:j] for i, j in zip(a, b)]


def _chunk_rows(x2w_ext, seps, n_real: int, ci: int, m: int, C: int,
                E: int):
    """The rows of text chunk ci, re-derived from the packed text:
    (wkey int64[C], is_main bool[C], f8 uint8[C]); the row at index i
    is text position ci * C + i. One launch of each kernel. seps: the
    chunk's separators on the device (_chunk_seps)."""
    dev = x2w_ext.device
    k = m - 1
    c0 = ci * C
    w0 = ci * (C // 16)
    # the word at w0 holds chars c0-16 .. c0-1 (the prologue is exactly
    # one word), so the chunk's own words start one word on
    wkey = ops.window_keys_packed(x2w_ext[w0 + 1 : w0 + E // 16], m, C)
    # predecessor chars: chars c0-1 .. c0+C-2
    pred = ops.unpack_2bit_words(
        x2w_ext[w0 : w0 + C // 16 + 1], 16 + C
    )[15 : 15 + C]
    # chunk-local separator mask over [c0-1, c0+C+k]
    SE = C + k + 2
    loc = seps - (c0 - 1)
    is_sep_ext = torch.zeros(SE, dtype=torch.bool, device=dev)
    is_sep_ext[loc] = True
    idx = torch.arange(SE, dtype=I32, device=dev)
    wds = torch.where(is_sep_ext, idx | POS_STOP, 0)
    wds[SE - 1] = (SE - 1) | POS_STOP
    nxt = seg_scan_or(wds, stop_bit=POS_STOP) & (POS_STOP - 1)
    dist = nxt[1 : 1 + C] - idx[1 : 1 + C]
    del wds, nxt, idx
    head = is_sep_ext[:C].clone()
    if ci == 0:
        head[0] = True                       # text position 0
    is_main = dist >= k
    is_main[max(0, n_real - c0):] = False    # positions past the text
    predf = pred.masked_fill(head, 7)
    f8 = ((dist == k).to(U8) << 4) | (head.to(U8) << 3) | predf
    return wkey, is_main, f8


def _select_group(
    x2w_ext,      # int32[W] packed codes of [16 T's] + text + T padding
    seps,         # per chunk, its separators on the device (_chunk_seps)
    n_real: int,  # true text length N
    g_lo: int,    # 62-bit group range lower bound (inclusive)
    g_hi: int,    # exclusive upper bound
    g_last: bool,  # last group (upper bound open)
    m: int, C: int, cap: int, E: int,
):
    """Scan all text chunks; copy the main rows whose node keys fall in
    this group's range into a cap-row buffer. Returns
    (key, ord, f8, n_rows); rows from n_rows on are pads (key all ones,
    ord PAD_ORD, f8 0). Rows stand in text order. When n_rows > cap the
    group has overflowed: the buffer holds only the chunks that fitted
    whole, and n_rows is still the group's full count. Each chunk's
    row count is one tracing.wait (grouped.select.wait)."""
    dev = x2w_ext.device
    bkey = torch.full((cap,), -1, dtype=I64, device=dev)
    bord = torch.full((cap,), PAD_ORD, dtype=I32, device=dev)
    bf8 = torch.zeros(cap, dtype=U8, device=dev)
    off = 0
    for ci, chunk_seps in enumerate(seps):
        wkey, is_main, f8 = _chunk_rows(x2w_ext, chunk_seps, n_real, ci,
                                        m, C, E)
        node = (wkey >> 2) & MASK62
        in_g = is_main & (node >= g_lo)
        if not g_last:
            in_g &= node < g_hi
        del node, is_main
        # the count blocks; the rows themselves stay on the device (a
        # tuple, so that wait counts no bytes fetched)
        (rows,) = tracing.wait(
            "grouped.select", lambda: (torch.nonzero(in_g).squeeze(1),))
        cnt = rows.shape[0]
        if off + cnt <= cap:
            bkey[off : off + cnt] = wkey[rows]
            bord[off : off + cnt] = (rows + (ci * C - ORD_BIAS)).to(I32)
            bf8[off : off + cnt] = f8[rows]
        off += cnt
    return bkey, bord, bf8, off


def _classify_rows(
    bkey, bord, bf8,            # cap-row select buffers
    s_key, s_ord, s_c6,         # int64/int32/uint8[ns_cap] special rows
    m: int, cap: int, ns_cap: int,
):
    """The engine's one-sort classification on one group's rows
    (engine.stage_graph semantics; reference mergeKmer
    src/INandOut.c:252-445), enqueued without a sync. Group-local row
    indices stay int32.

    Returns (fill2, rows, n_valid):
      fill2   uint8[(cap+ns_cap)/4] 2-bit-packed partial BWT chars of
              the sorted rows, 4 a byte, the first in bits 7:6 (blue
              slots and pad rows zero; fills are provably in 0..3 — see
              the pack comment below)
      rows    what _event_rows compacts: (mo_row, mi_row, r_ord, r_pred,
              seg_start) over the sorted rows
      n_valid the number of valid rows (a 0-d tensor)
    """
    R = cap + ns_cap
    assert R < SCAN_ROWS, R           # packed fact-broadcast bound
    assert R % 4 == 0, R              # 2-bit fill packing
    r_key, r_ord, r_f8 = ops.msort(
        (
            torch.cat([bkey[:cap], s_key]) ^ ops.SIGN,
            torch.cat([bord[:cap], s_ord]),
            torch.cat([bf8[:cap], s_c6]),
        ),
        num_keys=2,
    )
    is_node = r_ord < ORD_SPEC - ORD_BIAS
    row_valid = r_ord < ORD_PAD - ORD_BIAS
    is_spec = row_valid & ~is_node
    r_pred = (r_f8 & 7).to(I32)
    r_head = (r_f8 & 8) != 0
    r_tailw = (r_f8 & 16) != 0
    cls = torch.where(is_node, 0, torch.where(is_spec, 1, 2))
    # only equality and the low 2 bits of a key are read after the
    # sort, so keys stay flipped
    newseg = engine._changed(r_key >> 2) | engine._changed(cls)
    newseg[0] = True
    mo_ind = ((engine._changed(r_key & 3) & ~newseg) | r_tailw) & is_node
    del r_key, cls, r_tailw
    seg_start, mo_row, mi_row, pred_single_row = engine.segment_facts(
        newseg, is_node, r_pred, r_head, mo_ind
    )
    del newseg, mo_ind, r_head
    spec_char_row = r_f8 & 7
    fill6 = engine.fill_chars(
        is_spec, spec_char_row, mi_row, pred_single_row
    ).masked_fill(~row_valid, 0)
    n_valid = row_valid.sum()
    del is_spec, spec_char_row, pred_single_row, row_valid, r_f8

    # fills are provably in 0..3 here: spec chars are x6[p-1] with p-1
    # never a separator (reads longer than k, special.py), case-2
    # chars are single predecessor bases, and every '#'/'$' BWT char
    # belongs to a multi-in (blue) slot — head rows force mi_seg — so
    # those arrive via the blue fill. 2-bit pack: 4 chars/byte.
    q = fill6.view(R // 4, 4)
    fill2 = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    return fill2, (mo_row, mi_row, r_ord, r_pred, seg_start), n_valid


def _event_rows(mo_row, mi_row, r_ord, r_pred, seg_start):
    """The branch-event rows of a classified group, compacted (the count
    syncs). Returns (b_key, b_sgc, b_pos):
      b_key   int64[E_g] local idx<<2 | flags of the branch-event rows,
              ascending (flag 1 = SP event, 2 = blue)
      b_sgc   int64[E_g] blue (segment start << 3) | BWT char, else 0
      b_pos   int64[E_g] the rows' text positions

    SP events (multi-out rows: the reference emits the char k ahead
    per multi-out position, src/generateSP.c:626-651 — here that's
    just the row position; _sp_string recomputes the char) and blue
    entries (multi-in rows) are compacted together by one mask: flags
    ride the key's low bits and (seg_start, char) pack into one word
    (seg_start < 2^29, char 3 bits)."""
    ev = torch.nonzero(mo_row | mi_row).squeeze(1)
    mi_ev = mi_row[ev]
    b_key = (ev << 2) | mo_row[ev].to(I64) | (mi_ev.to(I64) << 1)
    ord_ev = r_ord[ev]
    pred_ev = r_pred[ev].to(I64)
    # blue char source (the row's own BWT char): pos 0 -> '$',
    # head -> '#', else the predecessor char
    bchar = torch.where(
        ord_ev == -ORD_BIAS, 5, torch.where(pred_ev == 7, 4, pred_ev)
    )
    b_sgc = torch.where(mi_ev, (seg_start[ev].to(I64) << 3) | bchar, 0)
    b_pos = ord_ev.to(I64) + ORD_BIAS
    return b_key, b_sgc, b_pos


def _group_rows(rows, n_valid):
    """What a group keeps for the back half, compacted from _event_rows
    on the device and fetched (the counts sync): host (ev_ord, bl_ord,
    bl_seg, bl_char) and n_valid as an int. Positions ride as int32
    ords (position - ORD_BIAS), segment starts group-local: 4 bytes a
    SP event and 9 a blue entry."""
    b_key, b_sgc, b_pos = _event_rows(*rows)
    ords = (b_pos - ORD_BIAS).to(I32)
    is_ev, is_bl = (b_key & 1) != 0, (b_key & 2) != 0
    sgc = b_sgc[is_bl]
    got = (ords[is_ev], ords[is_bl], (sgc >> 3).to(I32), (sgc & 7).to(U8))
    return tuple(a.cpu().numpy() for a in got) + (int(n_valid),)


def _sp_string(ev_ord, spec_branch_pos, x2w_ext, sep_d, N: int, k: int):
    """oocore.sp_string on the device, from the groups' SP event ords
    (host int32) and the text's packed words x2w_ext (16 T's first):
    (sp_pos int64, sp6 uint8), the events in text order and, per event,
    the char k ahead ('#' or '$' where the k-window ends at a
    separator)."""
    dev = x2w_ext.device
    pos = np.concatenate([ev_ord.astype(np.int64) + ORD_BIAS,
                          spec_branch_pos.astype(np.int64)])
    tracing.count("h2d_bytes", pos.nbytes)
    sp_pos = torch.sort(torch.from_numpy(pos).to(dev)).values
    ahead = sp_pos + k
    at = ahead + 16                      # the char's index in x2w_ext
    c = (x2w_ext[at >> 4] >> (2 * (15 - (at & 15))).to(I32)) & 3
    is_sepc = sep_d[torch.searchsorted(sep_d, sp_pos)] - sp_pos == k
    sp6 = torch.where(
        is_sepc, torch.where(ahead == N - 1, 5, 4), c.to(I64)).to(U8)
    return sp_pos, sp6


# ---- the JAX module's operands and results, as numpy arrays, into the
# ---- port's representation and back (for stage-by-stage comparison)

def ord_from_jax(ord_u32: np.ndarray) -> np.ndarray:
    """JAX uint32 ord (ORD_SPEC / ORD_PAD classes) -> the port's int32."""
    return (np.asarray(ord_u32).astype(np.int64) - ORD_BIAS).astype(np.int32)


def ord_to_jax(ord_i32: np.ndarray) -> np.ndarray:
    return (np.asarray(ord_i32).astype(np.int64) + ORD_BIAS).astype(np.uint32)


def select_from_jax(bhi, blo, bord, bf8, cap: int):
    """The first `cap` rows of the JAX `_select_group` buffers as the
    port's (key int64, ord int32, f8 uint8). The JAX buffers are
    compacted chunk by chunk by a sort, so the rows' order differs from
    the port's text order; compare as sets of rows."""
    return (
        ops.keys_from_pair(np.asarray(bhi)[:cap], np.asarray(blo)[:cap]),
        ord_from_jax(np.asarray(bord)[:cap]),
        np.asarray(bf8)[:cap],
    )


def select_to_jax(key, ord_i32, f8):
    """The port's select buffers as JAX (hi, lo, ord, f8) uint32/uint8."""
    hi, lo = ops.pair_from_keys(np.asarray(key))
    return hi, lo, ord_to_jax(ord_i32), np.asarray(f8)


def classify_from_jax(fill2, b_key, b_sgc, b_pos, n_g, E_g):
    """The JAX `_classify_group` results (R-row event arrays with a live
    prefix of E_g) as the port's (fill2, b_key, b_sgc, b_pos, n_g, E_g):
    _classify_rows's fills, _event_rows's arrays, the valid rows and
    the event rows."""
    E_g = int(E_g)
    return (
        np.asarray(fill2),
        np.asarray(b_key)[:E_g].astype(np.int64),
        np.asarray(b_sgc)[:E_g].astype(np.int64),
        np.asarray(b_pos)[:E_g].astype(np.int64),
        int(n_g), E_g,
    )


def classify_to_jax(fill2, b_key, b_sgc, b_pos, n_g, E_g, R: int):
    """The port's classification (_classify_rows, then _event_rows, the
    counts on the host) as the JAX `_classify_group` arrays: uint32[R]
    event arrays whose tail past E_g is (0xFFFFFFFF, 0, 0xFFFFFFFF)."""
    def full(a, pad):
        out = np.full(R, pad, dtype=np.uint32)
        out[:E_g] = np.asarray(a).astype(np.uint32)
        return out

    return (
        np.asarray(fill2), full(b_key, 0xFFFFFFFF), full(b_sgc, 0),
        full(b_pos, 0xFFFFFFFF), np.int32(n_g), np.int32(E_g),
    )


def _plan_groups(coll, k: int, cap: int, attempt: int):
    """Equal-depth 62-bit splitters for G groups of ~`_FILL * cap`
    rows each."""
    N = coll.bwt_len
    G = max(1, -(-N // max(1, int(cap * _FILL))))
    G = min(65536, G << attempt)      # retry doubles the group count
    if G == 1:
        return G, np.empty(0, np.uint64)
    splitters = sample_splitters64(
        coll.x2, G, k, seed=17 + attempt, samples=1 << 18
    )
    return G, splitters


def _unpack_fill(fill2: torch.Tensor, out: torch.Tensor) -> None:
    """out = the first out.shape[0] chars of 2-bit fill bytes (4 a
    byte, the first in bits 7:6)."""
    n = out.shape[0]
    for i in range(4):
        out[i::4] = (fill2[: -(-(n - i) // 4)] >> (6 - 2 * i)) & 3


def _sidecars(bwt6: torch.Tensor) -> torch.Tensor:
    """int64[2, n_reads]: the positions of the '#' and '$' entries of
    the BWT, ascending, over their chars."""
    p = torch.nonzero(bwt6 >= K.SHARP).squeeze(1)
    return torch.stack([p, bwt6[p].to(I64)]).cpu()


def _char_counts(bwt6: torch.Tensor) -> torch.Tensor:
    """int64[6]: how often each character stands in the BWT, counted
    ops.PACK_BLOCK positions at a time (a sum of `bwt6 == c` over all
    N widened it to 8 bytes a position on the card: 24 GB more reserved
    at 3 Gbp)."""
    got = torch.zeros(6, dtype=I64, device=bwt6.device)
    for s in range(0, bwt6.shape[0], ops.PACK_BLOCK):
        blk = bwt6[s : s + ops.PACK_BLOCK]
        for c in range(6):
            got[c] += (blk == c).sum()
    return got.cpu()


@tracing.recorded
def build_bwt_grouped(
    coll: SequenceCollection,
    config: PipelineConfig | None = None,
    gcfg: GroupedConfig | None = None,
    stats: dict | None = None,
    device=None,
    mesh=None,
) -> BwtResult:
    """Construct the BWT with bounded device memory. stats, when given,
    is filled with the group plan, the sorted SP stream and the kernels'
    launch counts (test hook). Runs on the CUDA card unless
    device="cpu" is passed. mesh enables sharded SP ranking past
    oocore.SP_CAP (the ooc x dist composition; see build_bwt_ooc).

    The result holds the packed words and the sidecars; its bwt6 is
    rebuilt from them on the host when it is read."""
    from debwt_tpu_torch.oocore import (
        SP_CAP, blue_order, expected_char_counts, sp_ranks,
    )

    config = config or PipelineConfig()
    gcfg = gcfg or GroupedConfig()
    dev = resolve_device(device)
    m, k = config.m, config.k
    N = coll.bwt_len
    if N >= MAX_N:
        raise NotImplementedError(
            f"grouped tier holds positions in 32 bits (N < {MAX_N}); "
            "route larger collections to the out-of-core tier"
        )
    trace = os.environ.get("DEBWT_TRACE") == "1"
    rec = tracing.current()
    launches0 = (_wk_counter.launches, seg_scan_or.launches)

    def _say(msg):
        if trace:
            print(f"[debwt-torch grouped] {msg}", file=sys.stderr)

    with tracing.span("grouped.special", "special module (host)"):
        sp = build_special(coll, m)
    n_spec = sp.spec_tfill.shape[0]
    assert n_spec < (1 << 28), n_spec

    C = min(gcfg.chunk, _pow2(max(1024, N)))
    C -= C % 16
    n_chunks = -(-N // C)
    E = C + m + 15
    E += (-E) % 16
    cap = gcfg.resolved_cap(dev, N, C)
    cap -= cap % 4

    with tracing.span("grouped.text", "text pack (host)"):
        # packed text with a 16-char T prologue (predecessor reads at
        # chunk starts) and a T tail covering the last chunk's window
        # lookahead
        x2w_ext = ops.pack_text(
            coll.x2, (16 + (n_chunks - 1) * C + E) // 16, dev, lead=1)
        sep = coll.sep.astype(np.int64)
        sep_d, seps = _chunk_seps(sep, dev, C, n_chunks, k)
        # the groups' fills, 4 rows a byte, each group from a byte of
        # its own: N / 4 bytes and at most one more a group (G <= 2^16)
        fill = torch.empty(N // 4 + (1 << 16) + 1, dtype=U8, device=dev)
        # special row operands (the engine's T-filled m-window trick:
        # spec key = node62 << 2 | T); spec_tfill IS the k-char node key
        # — the 62-bit splitter domain
        s_key_all = ((sp.spec_tfill << np.uint64(2)) | np.uint64(3)).view(
            np.int64)
        s_ord_all = (
            np.arange(n_spec, dtype=np.int64) + (ORD_SPEC - ORD_BIAS)
        ).astype(np.int32)
    tracing.count("h2d_bytes", N + sep.nbytes)

    n_selected = n_classified = 0
    select_peak = None
    cap_floor = 0     # a retry's cap_run never falls below what overflowed

    with tracing.span("grouped.groups", "group passes (device)"):
        for attempt in range(4):
            tracing.count("group_attempts")
            G, splitters = _plan_groups(coll, k, cap, attempt)
            spec_dest = (
                np.searchsorted(splitters, sp.spec_tfill, side="right")
                if G > 1 else np.zeros(n_spec, np.int64)
            )
            spec_counts = np.bincount(spec_dest, minlength=G)
            ns_cap = _pow2(max(16, int(spec_counts.max(initial=0))))
            # right-size the buffer to the plan: the sorts cost by the
            # buffer's rows, not the live ones. The JAX module lets this
            # shrink on a retry as G doubles, so that a group which
            # overflowed although `cap` had room overflows again; here a
            # retry keeps at least the rows of the group that overflowed.
            cap_run = min(cap, max(_bucket(int(N / G / _FILL)), cap_floor))
            cap_run = min(cap_run + (-cap_run) % 4, SCAN_ROWS - 4 - ns_cap)
            if cap_run < 4:
                raise GroupOverflow(
                    f"{ns_cap} special rows in one group leave no room "
                    f"under the {SCAN_ROWS}-row scan bound"
                )
            _say(f"plan: G={G} groups, cap={cap_run}, chunk={C} x "
                 f"{n_chunks}, ns_cap={ns_cap}")
            # every group's special rows in one upload, in group order
            # (splitters partition the keys monotonically, so the rows
            # keep their true order within a group)
            order = np.argsort(spec_dest, kind="stable")
            spec_d = [torch.from_numpy(a[order]).to(dev)
                      for a in (s_key_all, s_ord_all, sp.spec_bwt6)]
            spec_start = np.concatenate([[0], np.cumsum(spec_counts)])
            tracing.count("h2d_bytes", n_spec * 13)

            kept: list = []     # per group: (base, fill byte, rows,
            base = fo = 0       #   _group_rows' host arrays)
            overflow = False
            for g in range(G):
                lo62 = int(splitters[g - 1]) if g else 0
                hi62 = int(splitters[g]) if g < G - 1 else 0
                with tracing.span("grouped.select", "groups.select"):
                    bkey, bord, bf8, n_main = _select_group(
                        x2w_ext, seps, N, lo62, hi62, g == G - 1,
                        m, C, cap_run, E,
                    )
                n_selected += 1
                if select_peak is None and dev.type == "cuda":
                    # the allocator's peak so far: the first selection's
                    select_peak = torch.cuda.max_memory_allocated(dev)
                if n_main > cap_run:
                    _say(f"group {g} overflow: {n_main} rows > cap "
                         f"{cap_run}; retrying with more groups")
                    cap_floor = min(cap, max(cap_run, n_main))
                    overflow = True
                    break
                s0, s1 = int(spec_start[g]), int(spec_start[g + 1])
                n_g = n_main + s1 - s0
                with tracing.span("grouped.classify", "groups.classify"):
                    spec = []
                    for a, fillv in zip(spec_d, (-1, PAD_ORD, 0)):
                        pad = torch.full((ns_cap,), fillv, dtype=a.dtype,
                                         device=dev)
                        pad[: s1 - s0] = a[s0:s1]
                        spec.append(pad)
                    fill2, rows, n_valid = _classify_rows(
                        bkey, bord, bf8, *spec, m, cap_run, ns_cap)
                    del bkey, bord, bf8, spec
                    fill[fo : fo + (n_g + 3) // 4] = fill2[: (n_g + 3) // 4]
                    del fill2
                n_classified += 1
                with tracing.span("grouped.rows", "groups.fetch"):
                    *got, n_rows = tracing.wait(
                        "grouped.rows", lambda: _group_rows(rows, n_valid))
                    del rows, n_valid
                    assert n_rows == n_g, (n_rows, n_main, s1 - s0)
                    tracing.count("d2h_bytes", sum(a.nbytes for a in got))
                    kept.append((base, fo, n_g, got))
                base += n_g
                fo += (n_g + 3) // 4
                _say(f"group {g}: rows={n_g} sp={got[0].shape[0]} "
                     f"blue={got[1].shape[0]} base={base}")
            if not overflow:
                break
        else:
            raise GroupOverflow(
                "group overflow persisted after 4 full-depth splitter "
                f"refinements — a single node key has more than {cap_run} "
                f"occurrences (cap {cap}) and node groups must stay "
                "group-local; the out-of-core tier's giant-bucket path "
                "handles this"
            )
    assert base == N, (base, N)
    del spec_d, seps
    tracing.count("groups", G)

    # ---- SP string + ranks + blue fill: the ooc back half, on the card
    with tracing.span("grouped.sp", "SP rank"):
        sp_pos, sp6 = _sp_string(np.concatenate([g[0] for *_, g in kept]),
                                 sp.spec_branch_pos, x2w_ext, sep_d, N, k)
        del x2w_ext, sep_d
        L = sp_pos.shape[0]
        rank = sp_ranks(sp6, L, SP_CAP, dev, _say, mesh)
    _say(f"SP string: {L} events")

    with tracing.span("grouped.fill", "blue fill"):
        # the groups' fills into one byte a position, now that the
        # passes' buffers are freed
        bwt6 = torch.empty(N, dtype=U8, device=dev)
        for g_base, g_fo, n_g, _ in kept:
            _unpack_fill(fill[g_fo : g_fo + (n_g + 3) // 4],
                         bwt6[g_base : g_base + n_g])
        del fill
        b_base, b_pos, b_char = (np.concatenate(a) for a in zip(*(
            (g[2].astype(np.int64) + g_base, g[1].astype(np.int64) + ORD_BIAS,
             g[3]) for g_base, _, _, g in kept)))
        del kept
        n_blue = b_base.shape[0]
        tracing.count("h2d_bytes", b_base.nbytes + b_pos.nbytes + n_blue)
        coords, chars = blue_order(b_base, b_pos, b_char, rank, sp_pos, dev)
        bwt6[coords] = chars
        del b_base, b_pos, b_char, coords, chars, rank
    _say(f"blue entries: {n_blue}")
    tracing.count("sp_events", L)
    tracing.count("blue_entries", n_blue)

    with tracing.span("grouped.fill", "sidecars + pack (device)"):
        packed = torch.empty(-(-N // 16), dtype=I32, device=dev)
        ops.pack_codes(bwt6, packed)
        side = tracing.wait("grouped.fill", lambda: _sidecars(bwt6)).numpy()
        if config.check:
            got = tracing.wait("grouped.fill",
                               lambda: _char_counts(bwt6)).numpy()
            want = expected_char_counts(coll)
            assert (got == want).all(), (got, want)
        del bwt6
    sharp = side[0][side[1] == K.SHARP]
    dollar = side[0][side[1] == K.DOLLAR]
    assert dollar.shape[0] == 1, dollar

    if stats is not None:
        # the SP stream on the host (a test hook): one fetch more
        stats["sp_pos"], stats["sp6"] = tracing.wait("grouped.stats", lambda: (
            sp_pos.cpu().numpy(), sp6.cpu().numpy()))
        stats.update(
            n_groups=G, cap=cap, cap_run=cap_run, chunk=C, n_chunks=n_chunks,
            ns_cap=ns_cap, sp_len=L, n_blue=n_blue, attempts=attempt + 1,
            groups_selected=n_selected, groups_classified=n_classified,
            select_peak_bytes=select_peak,
            launches={
                "window_keys": _wk_counter.launches - launches0[0],
                "seg_scan_or": seg_scan_or.launches - launches0[1],
            },
            stage_s={k_: round(v, 3) for k_, v in rec.timings.items()},
        )
    return BwtResult(
        sharp_pos=sharp,
        dollar_pos=int(dollar[0]),
        packed_words=packed,
        _n=N,
        timings=rec.timings,
        counters=rec.counters,
    )
