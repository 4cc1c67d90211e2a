"""Single-device end-to-end pipeline orchestration.

Two device stages (engine.stage_graph / engine.stage_finish) with one
host sync in between for the dynamic SP/blue counts — the analogue of
the reference's cross-stage globals (case3num, blueCapacity, ...,
src/main.c:83-160). Sidecars, packing and conservation counts are
computed on the device; only the packed words and tiny metadata cross
back to the host (the full 6-letter BWT is fetched lazily on first
access).

Runs on the CUDA card unless the caller passes device="cpu"; with no
card and no explicit CPU request it raises rather than carry on on the
CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import engine, tracing
from debwt_tpu_torch.special import SpecialData, build_special
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

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
    sharp_pos: np.ndarray
    dollar_pos: int
    packed_words: torch.Tensor | None = None  # int32 words (uint32 bits)
    _bwt6: Any = None              # np.ndarray, tensor or None (words)
    _n: int = 0
    # per-stage wall seconds (the reference prints these on every run,
    # src/main.c:86-170; the CLI --timings flag surfaces them) and the
    # build's counts (tracing.py): both dicts, packed() adds to them
    timings: Any = None
    counters: Any = None

    @property
    def bwt6(self) -> np.ndarray:
        """The 6-letter BWT on the host: fetched from the device tensor
        the result holds, or, where it holds only the packed words and
        the sidecars (the grouped tier), rebuilt from them."""
        b = self._bwt6
        if b is None:
            from debwt_tpu_torch.golden import _UNPACK4

            words = self.packed_words.cpu().numpy().view(np.uint32)
            # big-endian words: a byte holds 4 codes, the first in 7:6
            b = _UNPACK4[words.astype(">u4").view(np.uint8)].reshape(-1)
            b = b[: self._n]
            b[self.sharp_pos] = K.SHARP
            b[self.dollar_pos] = K.DOLLAR
            object.__setattr__(self, "_bwt6", b)
        elif not isinstance(b, np.ndarray):
            b = b[: self._n].cpu().numpy()
            object.__setattr__(self, "_bwt6", b)
        return b

    @property
    def bwt2(self) -> np.ndarray:
        out = self.bwt6.copy()
        out[out >= 4] = K.T
        return out

    def packed(self) -> bytes:
        """The reference's on-disk layout: little-endian u64 words, 32
        bases/word, first base in bits 63:62. Its seconds go to
        timings["packed"], its fetch to counters."""
        for field in ("timings", "counters"):
            if getattr(self, field) is None:
                object.__setattr__(self, field, {})
        with tracing.recording(self.timings, self.counters), \
                tracing.span("pack", "packed"):
            if self.packed_words is not None:
                words = tracing.wait("pack", self.packed_words.cpu)
                with tracing.span("pack.assemble"):
                    w = words.numpy().view(np.uint32)
                    n_words = (self._n + 31) // 32
                    if w.shape[0] % 2:
                        w = np.concatenate([w, np.zeros(1, np.uint32)])
                    u64 = (w[0::2].astype(np.uint64) << np.uint64(32)) | w[
                        1::2
                    ].astype(np.uint64)
                    return u64[:n_words].astype("<u8").tobytes()
            with tracing.span("pack.assemble"):
                from debwt_tpu_torch.golden import pack_2bit_u64

                return pack_2bit_u64(self.bwt6)


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
        L_cap, B_cap = _bucket(L), _bucket(B)
        bwt6_d, packed_d, sharp_d, dollar_d, n_sharp_d, counts_d = (
            engine.stage_finish(
                x2p_d, ev_key, mi_row, seg_start, r_pos, bwt_char,
                bwt6_partial, spec_branch_d, N,
                m, inp.N_cap, L_cap, B_cap, _pow2(n),
            )
        )
        sharp = tracing.wait("finish", sharp_d.cpu).numpy().astype(np.int64)
        dollar, n_sharp = tracing.wait(
            "finish", lambda: torch.stack([dollar_d, n_sharp_d]).tolist())
    assert n_sharp == n - 1, (n_sharp, n)
    assert (sharp[: n - 1] < N).all()
    assert dollar < N
    if config.check:
        counts = tracing.wait("check", counts_d.cpu).numpy()
        want = np.bincount(coll.x6, minlength=6)
        assert (counts == want).all(), (counts, want)
    rec = tracing.current()
    return BwtResult(
        sharp_pos=sharp[: n - 1],
        dollar_pos=dollar,
        packed_words=packed_d,
        _bwt6=bwt6_d,
        _n=N,
        timings=rec.timings,
        counters=rec.counters,
    )
