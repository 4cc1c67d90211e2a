"""Kernel 2: segmented OR-carry scans over int32 words.

Replaces the Pallas TPU kernel `src/debwt_tpu/kernels/seg_or.py::
seg_scan_or` (and its wrapper `seg_suffix_or`). Two directions of one
recurrence, for a power-of-two STOP <= 2^29:

    suffix:  out[i] = w[i] | (w[i] & STOP ? 0 : out[i+1])
    prefix:  out[i] = w[i] | (w[i] & STOP ? 0 : out[i-1])

Both lift to the associative operator op(earlier, later) =
later | (later & STOP ? 0 : earlier) with identity 0, so one int32 word
carries the whole scan state. Whole words are scanned: the bits below
STOP are the facts, and out[i] also carries STOP iff a stop lies
between i and the far end of the scan. Callers mask with STOP - 1 (the
Pallas kernel and the JAX package's XLA sweep already disagree above
the fact bits).

On a CUDA tensor the wrapper launches the hand-written reduce-then-scan
kernel in `csrc/seg_or.cu` (three launches, blocks of TILE words; bound
by bytes). On a CPU tensor it runs `seg_scan_or_plain`, the log-shift
sweep of the JAX package's `_seg_or_xla` with the identity as fill.
`seg_scan_or_tiled` replays the kernel's own decomposition (warps,
tiles, carries) in torch, so the carry logic is tested where the kernel
cannot run.
"""

from __future__ import annotations

import ctypes

import torch

from debwt_tpu_torch.kernels import _build

TILE = 1024          # words per block; must equal csrc/seg_or.cu kTile
WARP = 32
CARRY_THREADS = 1024  # threads of the carry-scan block (kCarryThreads)


def _check_stop(stop_bit: int) -> None:
    if not (0 < stop_bit <= (1 << 29) and stop_bit & (stop_bit - 1) == 0):
        raise ValueError(f"stop_bit must be a power of two <= 2^29, got {stop_bit}")


def _op(earlier, later, stop: int):
    return later | torch.where((later & stop) != 0, 0, earlier)


def seg_scan_or_plain(words: torch.Tensor, stop_bit: int, prefix: bool):
    """Hillis-Steele sweep over the whole array (log2(R) steps)."""
    R = words.shape[0]
    s = 1
    while s < R:
        fill = torch.zeros(s, dtype=words.dtype, device=words.device)
        if prefix:
            shifted = torch.cat([fill, words[:-s]])
        else:
            shifted = torch.cat([words[s:], fill])
        words = _op(shifted, words, stop_bit)
        s *= 2
    return words


def _scan_rows(x: torch.Tensor, stop: int) -> torch.Tensor:
    """Inclusive scan along the last axis of width 32, as the kernel's
    __shfl_up_sync ladder does it: lane l absorbs lane l - d."""
    lane = torch.arange(WARP, device=x.device)
    d = 1
    while d < WARP:
        y = torch.cat([torch.zeros_like(x[..., :d]), x[..., :-d]], dim=-1)
        x = torch.where(lane >= d, _op(y, x, stop), x)
        d *= 2
    return x


def _block_scan(x: torch.Tensor, stop: int) -> torch.Tensor:
    """The kernel's block_scan on rows of TILE values: warp ladders,
    then warp 0 scans the 32 warp totals, then each warp > 0 folds in
    the total of the warps before it."""
    rows = x.shape[0]
    x = _scan_rows(x.view(rows, TILE // WARP, WARP), stop)
    tot = _scan_rows(x[:, :, -1], stop)
    before = torch.cat([torch.zeros_like(tot[:, :1]), tot[:, :-1]], dim=1)
    warp = torch.arange(TILE // WARP, device=x.device)
    x = torch.where((warp > 0)[:, None], _op(before[:, :, None], x, stop), x)
    return x.reshape(rows, TILE)


def _carry_scan(agg: torch.Tensor, stop: int) -> torch.Tensor:
    """The kernel's seg_or_carry: CARRY_THREADS threads each fold a run
    of `per` tile aggregates, one block scan, then each thread writes
    its tiles' exclusive carries serially."""
    n = agg.shape[0]
    per = -(-n // CARRY_THREADS)
    a = torch.zeros(CARRY_THREADS * per, dtype=agg.dtype, device=agg.device)
    a[:n] = agg
    a = a.view(CARRY_THREADS, per)
    acc = torch.zeros(CARRY_THREADS, dtype=agg.dtype, device=agg.device)
    for j in range(per):
        acc = _op(acc, a[:, j], stop)
    incl = _block_scan(acc.view(1, CARRY_THREADS), stop).view(-1)
    run = torch.cat([incl.new_zeros(1), incl[:-1]])
    carry = torch.empty_like(a)
    for j in range(per):
        carry[:, j] = run
        run = _op(run, a[:, j], stop)
    return carry.reshape(-1)[:n]


def seg_scan_or_tiled(words: torch.Tensor, stop_bit: int, prefix: bool):
    """CPU replay of the CUDA kernel: logical order, TILE-word tiles
    padded with the identity, reduce, carry scan, rescan."""
    _check_stop(stop_bit)
    R = words.shape[0]
    logical = words if prefix else words.flip(0)
    n_tiles = -(-R // TILE)
    x = torch.zeros(n_tiles * TILE, dtype=torch.int32, device=words.device)
    x[:R] = logical
    incl = _block_scan(x.view(n_tiles, TILE), stop_bit)
    carry = _carry_scan(incl[:, -1].contiguous(), stop_bit)
    out = _op(carry[:, None], incl, stop_bit).reshape(-1)[:R]
    return out if prefix else out.flip(0)


def _lib():
    lib = _build.load("seg_or")
    fn = lib.debwt_seg_scan_or
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.debwt_seg_or_tile.argtypes = []
        lib.debwt_seg_or_tile.restype = ctypes.c_int
        if lib.debwt_seg_or_tile() != TILE:
            raise RuntimeError("csrc/seg_or.cu kTile != seg_or.TILE")
    return fn


def seg_scan_or(
    words: torch.Tensor, stop_bit: int = 1 << 6, prefix: bool = False
) -> torch.Tensor:
    """Segmented OR-carry scan of int32 `words` (bits below stop_bit =
    facts, stop_bit = segment boundary: the LAST row of a segment for
    the suffix direction, the FIRST row for the prefix direction)."""
    _check_stop(stop_bit)
    if words.dim() != 1 or words.dtype != torch.int32:
        raise ValueError(
            f"words must be 1-D int32, got {words.dtype} {tuple(words.shape)}"
        )
    if words.device.type == "cpu":
        return seg_scan_or_plain(words, stop_bit, prefix)
    if words.device.type != "cuda":
        raise ValueError(f"seg_scan_or runs on cuda or cpu, not {words.device}")
    words = words.contiguous()
    R = words.shape[0]
    out = torch.empty_like(words)
    if R == 0:
        return out
    n_tiles = -(-R // TILE)
    scratch = torch.empty(2 * n_tiles, dtype=torch.int32, device=words.device)
    rc = _lib()(
        words.data_ptr(), out.data_ptr(), R, stop_bit, int(prefix),
        scratch.data_ptr(), scratch[n_tiles:].data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream,
    )
    _build.check(rc, "seg_scan_or launch")
    seg_scan_or.launches += 1
    return out


seg_scan_or.launches = 0


def seg_suffix_or(words: torch.Tensor) -> torch.Tensor:
    """out[i] = OR of fact bits (0..5) over [i, end of i's segment].
    words: int32[R], bits 0..5 = facts, bit 6 = STOP (last row of the
    segment; the global last row MUST have it set)."""
    return seg_scan_or(words, stop_bit=1 << 6, prefix=False)
