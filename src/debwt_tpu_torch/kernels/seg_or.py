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

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/seg_or.cu`: one pass with decoupled look-back, tiles of TILE
words, each word read once and written once (bound by bytes). On a CPU
tensor it runs `seg_scan_or_plain`, the log-shift sweep of the JAX
package's `_seg_or_xla` with the identity as fill. `seg_scan_or_tiled`
replays the kernel's own decomposition (physical tiles, chunks, warp
ladders, descriptors, look-back windows) in torch, so that logic is
tested where the kernel cannot run.
"""

from __future__ import annotations

import ctypes

import torch

from debwt_tpu_torch.kernels import _build

# The kernel's decomposition; TILE must equal csrc/seg_or.cu kTile.
WARP = 32
CHUNK = 4            # words per 16-byte load
ROWS = 4             # chunks per thread: a warp owns ROWS rows of WARP chunks
WARPS = 8            # warps per block
TILE = WARPS * ROWS * WARP * CHUNK   # 4096 words per block
WINDOW = 32          # descriptors per look-back step
EMPTY, AGGREGATE, INCLUSIVE = 0, 1, 2


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


def _tile_scan(x: torch.Tensor, stop: int):
    """The kernel's work inside a block, on rows of TILE words in
    logical order. Returns (c, warp_carry, pre, agg): c the chunk-local
    inclusive scans, shaped (tiles, WARPS, ROWS, WARP, CHUNK);
    warp_carry the fold of the warps before each warp; pre the fold of
    its own warp before each chunk; agg the fold of each whole tile."""
    n = x.shape[0]
    x = x.view(n, WARPS, ROWS, WARP, CHUNK)
    cols = [x[..., 0]]
    for k in range(1, CHUNK):             # a thread's serial scan
        cols.append(_op(cols[-1], x[..., k], stop))
    c = torch.stack(cols, dim=-1)
    s = _scan_rows(c[..., -1], stop)      # one ladder per warp row
    before = torch.cat([torch.zeros_like(s[..., :1]), s[..., :-1]], dim=-1)
    row_carry = torch.zeros_like(s[:, :, 0, 0])
    pre = []
    for j in range(ROWS):                 # a warp's rows chain serially
        pre.append(_op(row_carry[..., None], before[:, :, j], stop))
        row_carry = _op(row_carry, s[:, :, j, -1], stop)
    pre = torch.stack(pre, dim=2)
    agg = torch.zeros_like(row_carry[:, 0])
    warp_carry = []
    for v in range(WARPS):                # every thread folds the warp totals
        warp_carry.append(agg)
        agg = _op(agg, row_carry[:, v], stop)
    warp_carry = torch.stack(warp_carry, dim=1)
    return c, warp_carry, pre, agg


def _look_back(status, value, tile: int, stop: int):
    """The kernel's look_back for logical tile `tile` > 0 over the
    descriptors (status, value) as Python lists: windows of WINDOW
    descriptors, nearest first, each folded in order with the shuffle
    ladder, up to the nearest inclusive descriptor. Returns the fold of
    every tile before `tile` and the number of windows read."""
    lane = torch.arange(WINDOW)
    carry = 0
    top = tile - 1
    windows = 0
    while True:
        windows += 1
        tiles = [top - i for i in range(WINDOW)]
        st = [status[t] if t >= 0 else INCLUSIVE for t in tiles]
        incl = [i for i, q in enumerate(st) if q == INCLUSIVE]
        last = incl[0] if incl else WINDOW - 1
        assert EMPTY not in st[: last + 1], "look-back would spin forever"
        v = torch.tensor(
            [value[t] if t >= 0 and i <= last else 0 for i, t in enumerate(tiles)],
            dtype=torch.int32,
        )
        s = 1
        while s < WINDOW:                 # lane + s is the EARLIER tile
            y = torch.cat([v[s:], torch.zeros(s, dtype=torch.int32)])
            v = torch.where(lane + s < WINDOW, _op(y, v, stop), v)
            s *= 2
        carry = int(_op(v[:1], torch.tensor([carry], dtype=torch.int32), stop))
        if incl:
            return carry, windows
        top -= WINDOW


def seg_scan_or_tiled(
    words: torch.Tensor, stop_bit: int, prefix: bool, lookback: str = "inclusive"
):
    """CPU replay of the CUDA kernel's decomposition. Tiles are anchored
    at physical multiples of TILE and padded with the identity, so the
    ragged tile is the last logical tile of the prefix direction and the
    first of the suffix direction. `lookback` fixes what a tile finds
    when it looks back, which on the card depends on timing:

      "inclusive"  every earlier tile has published its inclusive prefix
                   (the look-back ends at the previous tile);
      "aggregate"  no earlier tile has, beyond what it knows alone: its
                   aggregate, which is inclusive only for tile 0 and for
                   an aggregate that carries STOP.

    Both give the plain version's whole words."""
    _check_stop(stop_bit)
    if lookback not in ("inclusive", "aggregate"):
        raise ValueError(f"lookback must be 'inclusive' or 'aggregate', got {lookback!r}")
    words = words.cpu()
    R = words.shape[0]
    n_tiles = -(-R // TILE)
    x = torch.zeros(n_tiles * TILE, dtype=torch.int32)
    x[:R] = words
    if not prefix:          # logical order: mirror tiles and words alike
        x = x.flip(0)
    c, warp_carry, pre, agg = _tile_scan(x.view(n_tiles, TILE), stop_bit)
    agg_l = agg.tolist()
    status, value, carries = [], [], []
    for t in range(n_tiles):              # tiles in ticket order
        closed = t == 0 or (agg_l[t] & stop_bit) != 0
        status.append(INCLUSIVE if closed else AGGREGATE)
        value.append(agg_l[t])
        carry = _look_back(status, value, t, stop_bit)[0] if t else 0
        carries.append(carry)
        if lookback == "inclusive" and not closed:
            a = torch.tensor([agg_l[t]], dtype=torch.int32)
            status[t] = INCLUSIVE
            value[t] = int(_op(torch.tensor([carry], dtype=torch.int32), a, stop_bit))
    carry = torch.tensor(carries, dtype=torch.int32)
    p = _op(_op(carry[:, None], warp_carry, stop_bit)[:, :, None, None], pre, stop_bit)
    out = _op(p[..., None], c, stop_bit).reshape(-1)
    if not prefix:
        out = out.flip(0)
    return out[:R]


def _lib():
    lib = _build.load("seg_or")
    fn = lib.debwt_seg_scan_or
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
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
    # one zeroed 64-bit descriptor a tile, then the ticket
    scratch = torch.zeros(n_tiles + 1, dtype=torch.int64, device=words.device)
    rc = _lib()(
        words.data_ptr(), out.data_ptr(), R, stop_bit, int(prefix),
        scratch.data_ptr(), torch.cuda.current_stream(words.device).cuda_stream,
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
