"""Single-device end-to-end pipeline orchestration, and the result every
tier returns.

Two device stages (engine.stage_graph / engine.stage_finish) with one
host sync in between for the dynamic SP/blue counts — the analogue of
the reference's cross-stage globals (case3num, blueCapacity, ...,
src/main.c:83-160).

Every tier (this one, grouped, oocore, parallel.dist) finishes its
6-letter BWT the same way, with BwtResult.from_bwt6 on the device that
holds it: the 2-bit words, the '#'/'$' sidecars and, under
PipelineConfig.check, the character counts. A result holds the words
on that device and the sidecars on the host; packed() fetches the
words once in the file's order, and the 6-letter BWT is rebuilt from
words and sidecars on first access.

Runs on the CUDA card unless the caller passes device="cpu"; with no
card and no explicit CPU request it raises rather than carry on on the
CPU.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import engine, ops, tracing
from debwt_tpu_torch.special import SpecialData, build_special
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

# packed() hands out the words' own bytes as the file's little-endian
# u64 words
assert sys.byteorder == "little", "the <obj> layout needs a little-endian host"

# fused-engine row bound (engine.stage_graph packs class and position
# into int32 sort operands and fact broadcasts below 2^29)
MAX_ROWS = 1 << 29


def resolve_device(device=None) -> torch.device:
    """torch.device("cuda") unless the caller names another; raises if
    the chosen device is CUDA and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class BwtResult:
    """A finished BWT, as every tier returns it (from_bwt6): the 2-bit
    words on the device that made them, the '#'/'$' sidecars on the
    host, and the build's timings and counters."""

    sharp_pos: np.ndarray
    dollar_pos: int
    packed_words: torch.Tensor     # int32 words (uint32 bits)
    _n: int                        # BWT length
    # per-stage wall seconds (the reference prints these on every run,
    # src/main.c:86-170; the CLI --timings flag surfaces them) and the
    # build's counts (tracing.py); packed() adds to both
    timings: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    # the host cache of the bwt6 property
    _bwt6: np.ndarray | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @classmethod
    def from_bwt6(cls, bwt6: torch.Tensor, n_reads: int,
                  want_counts: np.ndarray | None = None) -> BwtResult:
        """The result of the 6-letter BWT `bwt6` (uint8[N], on any
        device), made on that device: the words, packed ops.PACK_BLOCK
        codes at a time, and the sidecars from one nonzero, fetched in
        one wait. Asserts n_reads - 1 '#' and one '$', and, where
        want_counts is given (expected_char_counts), that the BWT holds
        each character that often. Timings and counters are those of
        the recording open on the thread."""
        N = bwt6.shape[0]
        words = torch.empty(-(-N // 16), dtype=torch.int32, device=bwt6.device)
        ops.pack_codes(bwt6, words)

        def sidecars():
            p = torch.nonzero(bwt6 >= K.SHARP).squeeze(1)
            return torch.stack([p, bwt6[p].to(torch.int64)]).cpu()

        pos, char = tracing.wait("finish", sidecars).numpy()
        sharp, dollar = pos[char == K.SHARP], pos[char == K.DOLLAR]
        assert sharp.shape[0] == n_reads - 1, (sharp.shape, n_reads)
        assert dollar.shape[0] == 1, dollar
        if want_counts is not None:
            got = tracing.wait("finish", lambda: _char_counts(bwt6)).numpy()
            assert (got == want_counts).all(), (got, want_counts)
        rec = tracing.current() or tracing.Recorder()
        return cls(sharp_pos=sharp, dollar_pos=int(dollar[0]),
                   packed_words=words, _n=N, timings=rec.timings,
                   counters=rec.counters)

    @property
    def bwt6(self) -> np.ndarray:
        """The 6-letter BWT on the host, rebuilt from the packed words
        and the sidecars on first read."""
        if self._bwt6 is None:
            from debwt_tpu_torch.golden import _UNPACK4

            words = self.packed_words.cpu().numpy().view(np.uint32)
            # big-endian words: a byte holds 4 codes, the first in 7:6
            b = _UNPACK4[words.astype(">u4").view(np.uint8)].reshape(-1)
            b = b[: self._n]
            b[self.sharp_pos] = K.SHARP
            b[self.dollar_pos] = K.DOLLAR
            object.__setattr__(self, "_bwt6", b)
        return self._bwt6

    @property
    def bwt2(self) -> np.ndarray:
        out = self.bwt6.copy()
        out[out >= 4] = K.T
        return out

    def packed(self) -> bytes:
        """The reference's on-disk layout: little-endian u64 words, 32
        bases/word, first base in bits 63:62. That order is made on the
        words' device and fetched once (counter pack_on_device). Its
        seconds go to timings["packed"], its fetch to counters."""
        with tracing.recording(self.timings, self.counters), \
                tracing.span("pack", "packed"):
            words = tracing.wait("pack", _file_order(
                self.packed_words, (self._n + 31) // 32).cpu)
            tracing.count("pack_on_device")
            with tracing.span("pack.assemble"):
                return words.numpy().tobytes()


def _char_counts(bwt6: torch.Tensor) -> torch.Tensor:
    """int64[6]: how often each character stands in the BWT, counted
    ops.PACK_BLOCK positions at a time (a sum of `bwt6 == c` over all
    N widened it to 8 bytes a position on the card: 24 GB more reserved
    at 3 Gbp)."""
    got = torch.zeros(6, dtype=torch.int64, device=bwt6.device)
    for s in range(0, bwt6.shape[0], ops.PACK_BLOCK):
        blk = bwt6[s : s + ops.PACK_BLOCK]
        for c in range(6):
            got[c] += (blk == c).sum()
    return got.cpu()


# characters a block of char_counts: at 3 Gbp np.bincount of the whole
# array would widen it to 24 GB of intp, and a block of 1 MiB keeps the
# six compare-and-count passes over it in the cache, not in memory
_COUNT_BLOCK = 1 << 20


def char_counts(a: np.ndarray) -> np.ndarray:
    """int64[6] counts of the codes 0..5 in `a`, a block at a time."""
    out = np.zeros(6, dtype=np.int64)
    for s in range(0, a.shape[0], _COUNT_BLOCK):
        blk = a[s : s + _COUNT_BLOCK]
        out += [np.count_nonzero(blk == c) for c in range(6)]
    return out


def expected_char_counts(coll: SequenceCollection) -> np.ndarray:
    """int64[6]: how often the BWT holds each character, as the text
    (coll.x6) does: the counts of x2, less what its separator positions
    hold, plus n_reads - 1 '#' and one '$' (no N-byte x6 copy)."""
    want = char_counts(coll.x2) - np.bincount(coll.x2[coll.sep], minlength=6)[:6]
    want[K.SHARP] += coll.n_reads - 1
    want[K.DOLLAR] += 1
    return want


def _file_order(words: torch.Tensor, n64: int) -> torch.Tensor:
    """int32[n64, 2] on the words' device whose little-endian bytes are
    the <obj> file's: file word i is (words[2i] << 32) | words[2i + 1],
    so each pair of words is swapped; a missing last odd word is 0."""
    head = words[: 2 * n64]
    out = torch.empty(n64, 2, dtype=torch.int32, device=words.device)
    out[:, 1] = head[0::2]
    odd = head[1::2]
    out[: odd.shape[0], 0] = odd
    out[odd.shape[0]:, 0] = 0
    return out


def _pow2(x: int) -> int:
    return max(16, 1 << (int(x) - 1).bit_length())


def _bucket(x: int) -> int:
    """Next eighth-power-of-two >= x (< 25% padding worst case, e.g.
    65 -> 80) — shape bucketing, kept from the JAX package so that both
    engines see the same padded inputs."""
    x = max(64, int(x))
    b = (x - 1).bit_length()
    step = 1 << max(0, b - 3)
    return -(-x // step) * step


def rows_needed(coll: SequenceCollection, m: int) -> int:
    """Sorted rows of the fused engine: bucketed text plus specials."""
    return _bucket(coll.bwt_len) + _pow2(coll.n_reads * (m - 1))


@dataclasses.dataclass(frozen=True)
class StageInputs:
    """The small padded host inputs of engine.stage_graph (numpy); the
    text itself goes to the device as it is (build_bwt)."""

    sep_pos: np.ndarray      # int32[_pow2(n)], pad N_cap
    spec_key: np.ndarray     # int64[ns_cap] T-filled keys, pad -1
    spec_char6: np.ndarray   # uint8[ns_cap], pad 0
    spec_branch: np.ndarray  # int32[_pow2(#branches)], pad N_cap
    n_real: int
    N_cap: int


def _padded(a: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full(cap, fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def stage_inputs(
    coll: SequenceCollection, m: int, sp: SpecialData | None = None
) -> StageInputs:
    sp = sp if sp is not None else build_special(coll, m)
    N = coll.bwt_len
    N_cap = _bucket(N)
    spec_key = sp.spec_tfill.view(np.int64)
    return StageInputs(
        sep_pos=_padded(coll.sep.astype(np.int32), _pow2(coll.n_reads), N_cap),
        spec_key=_padded(spec_key, _pow2(spec_key.shape[0]), -1),
        spec_char6=_padded(sp.spec_bwt6, _pow2(spec_key.shape[0]), 0),
        spec_branch=_padded(
            sp.spec_branch_pos.astype(np.int32),
            _pow2(max(1, sp.spec_branch_pos.shape[0])), N_cap,
        ),
        n_real=N,
        N_cap=N_cap,
    )


@tracing.recorded
def build_bwt(
    coll: SequenceCollection,
    config: PipelineConfig | None = None,
    device=None,
) -> BwtResult:
    config = config or PipelineConfig()
    dev = resolve_device(device)
    m = config.m
    N = coll.bwt_len
    n = coll.n_reads
    if rows_needed(coll, m) >= MAX_ROWS:
        raise NotImplementedError(
            "single-device engine: text must be < ~512 Mbp (R < 2^29 "
            "rows); api.build routes a larger collection to the grouped "
            "tier"
        )

    # ---- host: special module (tiny, irregular) ----
    with tracing.span("special", "special module (host)"):
        sp = build_special(coll, m)
    with tracing.span("graph", "stage_graph (+h2d, sync)"):
        with tracing.span("graph.inputs"):
            inp = stage_inputs(coll, m, sp)
        with tracing.span("graph.h2d"):
            # the text crosses once, as its codes, straight into the
            # T-padded device buffer the engine keeps: no host staging
            # copy, and the tail is filled on the device
            x2p_d = torch.empty(inp.N_cap + K.TAIL_PAD, dtype=torch.uint8,
                                device=dev)
            x2p_d[:N].copy_(torch.from_numpy(coll.x2))
            x2p_d[N:].fill_(K.T)
            small = (inp.sep_pos, inp.spec_key, inp.spec_char6,
                     inp.spec_branch)
            tracing.count("h2d_bytes", N + sum(a.nbytes for a in small))
            sep_d, key_d, char_d, spec_branch_d = (
                torch.from_numpy(a).to(dev) for a in small)
        with tracing.span("graph.enqueue"):
            out = engine.stage_graph(
                x2p_d, sep_d, key_d, char_d, spec_branch_d, N, m, inp.N_cap,
            )
        (bwt6_partial, ev_key, mi_row, seg_start, r_pos,
         bwt_char, L, B, x2p_d) = out
        # the one mid-build sync
        L, B = tracing.wait("graph", lambda: torch.stack([L, B]).tolist())
    tracing.count("rows", inp.N_cap + inp.spec_key.shape[0])
    tracing.count("sp_events", L)
    tracing.count("blue_entries", B)

    with tracing.span("finish", "stage_finish (+sync)"):
        # eighth-power buckets (like N_cap), not powers of two, to keep
        # the L-sized rank-loop sorts from padding by up to 2x
        bwt6_d = engine.stage_finish(
            x2p_d, ev_key, mi_row, seg_start, r_pos, bwt_char,
            bwt6_partial, spec_branch_d, N,
            m, inp.N_cap, _bucket(L), _bucket(B),
        )
        return BwtResult.from_bwt6(
            bwt6_d[:N], n, expected_char_counts(coll) if config.check else None)
