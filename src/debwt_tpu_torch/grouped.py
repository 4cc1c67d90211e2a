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
  * only outputs cross to the host: 2-bit packed fill characters, SP
    event positions and blue entries (branch events only — tiny next
    to the text). SP ranking and the blue fill are the out-of-core
    tier's back half (oocore.sp_string, oocore._sp_ranks_host,
    oocore.blue_fill).

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
import time

import numpy as np
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import engine, ops, tracing
from debwt_tpu_torch.golden import _UNPACK4   # fill2 byte -> 4 chars
from debwt_tpu_torch.kernels.seg_or import seg_scan_or
from debwt_tpu_torch.kernels.window_keys import window_keys as _wk_counter
from debwt_tpu_torch.pipeline import BwtResult, _bucket, _pow2, resolve_device
from debwt_tpu_torch.special import _cached_buf, build_special
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
# by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (see PERF.md):
# the caching allocator's reserved peak of a whole build over the rows
# of its largest group (R = cap_run + ns_cap) was 129.65 at R =
# 41,943,104 (140 Mbp in 4 groups), 105.77 at R = 402,653,248 (600 Mbp
# in 2 groups) and 101.68 at R = 536,870,908, the scan bound (3 Gbp in
# 7 groups); the largest, rounded up. A text position of one
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
    what the free memory holds beside the resident packed text and one
    chunk's selection transients. The CPU is bound by the scans alone."""
    cap = SCAN_ROWS - 4
    if dev.type == "cuda":
        from debwt_tpu_torch.api import _device_memory_bytes

        free = _device_memory_bytes(dev) - n // 4 - chunk * _SELECT_BYTES_PER_POS
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


def _chunk_rows(x2w_ext, sep: np.ndarray, n_real: int, ci: int,
                m: int, C: int, E: int):
    """The rows of text chunk ci, re-derived from the packed text:
    (wkey int64[C], is_main bool[C], f8 uint8[C]); the row at index i
    is text position ci * C + i. One launch of each kernel."""
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
    a, b = np.searchsorted(sep, [c0 - 1, c0 - 1 + SE])
    loc = torch.from_numpy(sep[a:b] - (c0 - 1)).to(dev)
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
    sep,          # host int64[n_reads] separator positions, ascending
    n_real: int,  # true text length N
    g_lo: int,    # 62-bit group range lower bound (inclusive)
    g_hi: int,    # exclusive upper bound
    g_last: bool,  # last group (upper bound open)
    m: int, C: int, cap: int, n_chunks: int, E: int,
):
    """Scan all text chunks; copy the main rows whose node keys fall in
    this group's range into a cap-row buffer. Returns
    (key, ord, f8, n_rows); rows from n_rows on are pads (key all ones,
    ord PAD_ORD, f8 0). Rows stand in text order. When n_rows > cap the
    group has overflowed: the buffer holds only the chunks that fitted
    whole, and n_rows is still the group's full count."""
    dev = x2w_ext.device
    bkey = torch.full((cap,), -1, dtype=I64, device=dev)
    bord = torch.full((cap,), PAD_ORD, dtype=I32, device=dev)
    bf8 = torch.zeros(cap, dtype=U8, device=dev)
    off = 0
    for ci in range(n_chunks):
        wkey, is_main, f8 = _chunk_rows(x2w_ext, sep, n_real, ci, m, C, E)
        node = (wkey >> 2) & MASK62
        in_g = is_main & (node >= g_lo)
        if not g_last:
            in_g &= node < g_hi
        del node, is_main
        rows = torch.nonzero(in_g).squeeze(1)     # syncs: the count
        cnt = rows.shape[0]
        if off + cnt <= cap:
            bkey[off : off + cnt] = wkey[rows]
            bord[off : off + cnt] = (rows + (ci * C - ORD_BIAS)).to(I32)
            bf8[off : off + cnt] = f8[rows]
        off += cnt
    return bkey, bord, bf8, off


def _classify_group(
    bkey, bord, bf8,            # cap-row select buffers
    s_key, s_ord, s_c6,         # int64/int32/uint8[ns_cap] special rows
    m: int, cap: int, ns_cap: int,
):
    """The engine's one-sort classification on one group's rows
    (engine.stage_graph semantics; reference mergeKmer
    src/INandOut.c:252-445). Group-local row indices stay int32.

    Returns (fill2, b_key, b_sgc, b_pos, n_g, E_g):
      fill2   uint8[(cap+ns_cap)/4] 2-bit-packed partial BWT chars of
              the first n_g sorted rows (blue slots zero; fills are
              provably in 0..3 — see the pack comment below)
      b_key   int64[E_g] local idx<<2 | flags of the branch-event rows,
              ascending (flag 1 = SP event, 2 = blue)
      b_sgc   int64[E_g] blue (segment start << 3) | BWT char, else 0
      b_pos   int64[E_g] the rows' text positions
    """
    R = cap + ns_cap
    assert R < SCAN_ROWS, R           # packed fact-broadcast bound
    assert R % 4 == 0, R              # 2-bit fill packing
    dev = bkey.device
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
    n_g = int(row_valid.sum())
    del is_spec, spec_char_row, pred_single_row, row_valid, r_f8

    # SP events (multi-out rows: the reference emits the char k ahead
    # per multi-out position, src/generateSP.c:626-651 — here that's
    # just the row position; the host recomputes the char) and blue
    # entries (multi-in rows) are compacted together by one mask: flags
    # ride the key's low bits and (seg_start, char) pack into one word
    # (seg_start < 2^29, char 3 bits).
    ev = torch.nonzero(mo_row | mi_row).squeeze(1)    # syncs: E_g
    E_g = ev.shape[0]
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

    # fills are provably in 0..3 here: spec chars are x6[p-1] with p-1
    # never a separator (reads longer than k, special.py), case-2
    # chars are single predecessor bases, and every '#'/'$' BWT char
    # belongs to a multi-in (blue) slot — head rows force mi_seg — so
    # those arrive via the host blue fill. 2-bit pack: 4 chars/byte.
    q = fill6.view(R // 4, 4)
    fill2 = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    return fill2, b_key, b_sgc, b_pos, n_g, E_g


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
    prefix of E_g) as the port's (fill2, b_key, b_sgc, b_pos, n_g, E_g)."""
    E_g = int(E_g)
    return (
        np.asarray(fill2),
        np.asarray(b_key)[:E_g].astype(np.int64),
        np.asarray(b_sgc)[:E_g].astype(np.int64),
        np.asarray(b_pos)[:E_g].astype(np.int64),
        int(n_g), E_g,
    )


def classify_to_jax(fill2, b_key, b_sgc, b_pos, n_g, E_g, R: int):
    """The port's `_classify_group` results as the JAX arrays: uint32[R]
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
    oocore.SP_CAP (the ooc x dist composition; see build_bwt_ooc)."""
    from debwt_tpu_torch.oocore import (
        SP_CAP, _sp_ranks_host, blue_fill, check_char_counts, sp_string,
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
    timings = tracing.current().timings
    launches0 = (_wk_counter.launches, seg_scan_or.launches)

    def _say(msg):
        if trace:
            print(f"[debwt-torch grouped] {msg}", file=sys.stderr)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sp = build_special(coll, m)
    n_spec = sp.spec_tfill.shape[0]
    assert n_spec < (1 << 28), n_spec
    tracing.mark("special module (host)", dev)

    C = min(gcfg.chunk, _pow2(max(1024, N)))
    C -= C % 16
    n_chunks = -(-N // C)
    E = C + m + 15
    E += (-E) % 16
    cap = gcfg.resolved_cap(dev, N, C)
    cap -= cap % 4

    # packed text with a 16-char T prologue (predecessor reads at chunk
    # starts) and a T tail covering the last chunk's window lookahead
    ext_len = 16 + (n_chunks - 1) * C + E
    x2ext = _cached_buf("grouped_ext", ext_len)
    x2ext[:16] = K.T
    x2ext[16 : 16 + N] = coll.x2
    x2ext[16 + N :] = K.T
    x2w_ext = torch.from_numpy(
        ops.pack_2bit_words_host(x2ext).view(np.int32)
    ).to(dev)
    del x2ext
    sep = coll.sep.astype(np.int64)
    tracing.mark("text pack (host)", dev)

    # special row operands (the engine's T-filled m-window trick:
    # spec key = node62 << 2 | T); spec_tfill IS the k-char node key —
    # the 62-bit splitter domain
    s_key_all = ((sp.spec_tfill << np.uint64(2)) | np.uint64(3)).view(np.int64)
    s_ord_all = (
        np.arange(n_spec, dtype=np.int64) + (ORD_SPEC - ORD_BIAS)
    ).astype(np.int32)

    fine = {"select": 0.0, "classify": 0.0, "fetch": 0.0}
    n_selected = n_classified = 0
    select_peak = None
    cap_floor = 0     # a retry's cap_run never falls below what overflowed

    for attempt in range(4):
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
                f"{ns_cap} special rows in one group leave no room under "
                f"the {SCAN_ROWS}-row scan bound"
            )
        _say(f"plan: G={G} groups, cap={cap_run}, chunk={C} x {n_chunks}, "
             f"ns_cap={ns_cap}")

        def _sp_pad(a, fillv, smask):
            out = np.full(ns_cap, fillv, dtype=a.dtype)
            sel_a = a[smask]
            out[: sel_a.shape[0]] = sel_a
            return torch.from_numpy(out).to(dev)

        bwt6 = np.empty(N, dtype=np.uint8)
        ev_parts: list[np.ndarray] = []
        blue_parts: list[tuple] = []
        base = 0
        overflow = False
        for g in range(G):
            t0 = time.perf_counter()
            lo62 = int(splitters[g - 1]) if g else 0
            hi62 = int(splitters[g]) if g < G - 1 else 0
            bkey, bord, bf8, n_main = _select_group(
                x2w_ext, sep, N, lo62, hi62, g == G - 1,
                m, C, cap_run, n_chunks, E,
            )
            n_selected += 1
            _sync()
            fine["select"] += time.perf_counter() - t0
            if select_peak is None and dev.type == "cuda":
                # the allocator's peak so far: the first selection's own
                select_peak = torch.cuda.max_memory_allocated(dev)
            t0 = time.perf_counter()
            if n_main > cap_run:
                _say(f"group {g} overflow: {n_main} rows > cap "
                     f"{cap_run}; retrying with more groups")
                cap_floor = min(cap, max(cap_run, n_main))
                overflow = True
                break
            smask = spec_dest == g
            fill2, b_key, b_sgc, b_pos, n_g, E_g = _classify_group(
                bkey, bord, bf8,
                _sp_pad(s_key_all, np.int64(-1), smask),
                _sp_pad(s_ord_all, np.int32(PAD_ORD), smask),
                _sp_pad(sp.spec_bwt6, np.uint8(0), smask),
                m, cap_run, ns_cap,
            )
            n_classified += 1
            del bkey, bord, bf8
            assert n_g == n_main + int(smask.sum()), (
                n_g, n_main, int(smask.sum())
            )
            nb = (n_g + 3) // 4
            _sync()
            fine["classify"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            f2 = fill2[:nb].cpu().numpy()
            key_h = b_key.cpu().numpy()
            sgc_h = b_sgc.cpu().numpy()
            pos_h = b_pos.cpu().numpy()
            del fill2, b_key, b_sgc, b_pos
            bwt6[base : base + n_g] = _UNPACK4[f2].reshape(-1)[:n_g]
            is_ev = (key_h & 1) != 0
            is_bl = (key_h & 2) != 0
            L_g, B_g = int(is_ev.sum()), int(is_bl.sum())
            if L_g:
                ev_parts.append(pos_h[is_ev])
            if B_g:
                blue_parts.append((
                    base + (sgc_h[is_bl] >> 3),
                    pos_h[is_bl],
                    (sgc_h[is_bl] & 7).astype(np.uint8),
                ))
            base += n_g
            fine["fetch"] += time.perf_counter() - t0
            _say(f"group {g}: rows={n_g} sp={L_g} blue={B_g} "
                 f"base={base}")
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
    del x2w_ext
    tracing.mark("group passes (device)", dev)
    for kk, vv in fine.items():
        tracing.add(f"groups.{kk}", round(vv, 3))
    # the plan, the splitter sample, the special rows' upload and the
    # allocation of the host BWT: the group passes less the three above
    tracing.add("groups.other", round(
        timings["group passes (device)"] - sum(fine.values()), 3
    ))

    # ---- SP string + ranks + blue fill: the ooc back half ----
    x2p = np.concatenate(
        [coll.x2, np.full(K.TAIL_PAD, K.T, dtype=np.uint8)]
    )
    sp_pos, sp6 = sp_string(ev_parts, sp.spec_branch_pos, sep, x2p, N, k)
    L = sp_pos.shape[0]
    rank = _sp_ranks_host(sp6, L, SP_CAP, dev, _say, mesh)
    tracing.mark("SP rank", dev)
    _say(f"SP string: {L} events")

    n_blue = blue_fill(bwt6, blue_parts, rank, sp_pos, dev)
    tracing.mark("blue fill", dev)
    _say(f"blue entries: {n_blue}")
    tracing.count("sp_events", L)
    tracing.count("blue_entries", n_blue)

    if config.check:
        check_char_counts(bwt6, coll)
    tracing.mark("count check (host)", dev)
    (sharp,) = np.nonzero(bwt6 == K.SHARP)
    (dollar,) = np.nonzero(bwt6 == K.DOLLAR)
    assert dollar.shape[0] == 1, dollar
    tracing.mark("sidecars (host)", dev)

    if stats is not None:
        stats.update(
            n_groups=G, cap=cap, cap_run=cap_run, chunk=C, n_chunks=n_chunks,
            ns_cap=ns_cap, sp_len=L, n_blue=n_blue, attempts=attempt + 1,
            groups_selected=n_selected, groups_classified=n_classified,
            sp_pos=sp_pos, sp6=sp6, select_peak_bytes=select_peak,
            launches={
                "window_keys": _wk_counter.launches - launches0[0],
                "seg_scan_or": seg_scan_or.launches - launches0[1],
            },
            stage_s={k_: round(v, 3) for k_, v in timings.items()},
        )
    return BwtResult(
        sharp_pos=sharp.astype(np.int64),
        dollar_pos=int(dollar[0]),
        _bwt6=bwt6,
        _n=N,
        timings=timings,
        counters=tracing.current().counters,
    )
