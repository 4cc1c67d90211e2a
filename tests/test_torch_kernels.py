"""The port's kernels against the JAX package's, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves run only on the card (tests/test_torch_gpu.py). The
seg-OR kernel's decomposition (physical tiles, chunks, warp ladders,
descriptors, look-back windows) is replayed in torch
(seg_scan_or_tiled) at the kernel's own tile size, in both look-back
modes, and the window-key kernel's word and funnel-shift arithmetic in
window_keys_words_replay, so that logic is checked here too. JAX runs
its Pallas kernels in interpret mode, as tests/test_kernels.py does.
All data is integer: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debwt_tpu import engine as jengine
from debwt_tpu import ops as jops
from debwt_tpu.kernels.seg_or import seg_scan_or as jax_seg_scan_or
from debwt_tpu.kernels.window_keys import TILE as PALLAS_TILE
from debwt_tpu.kernels.window_keys import window_keys_pallas
from debwt_tpu_torch import engine as tengine
from debwt_tpu_torch.kernels import seg_or as tseg
from debwt_tpu_torch.kernels.window_keys import (
    window_keys,
    window_keys_at,
    window_keys_at_plain,
    window_keys_packed,
    window_keys_packed_plain,
    window_keys_words_replay,
)
from debwt_tpu_torch.ops import keys_from_pair, pack_2bit_words_host

T = tseg.TILE


@pytest.mark.parametrize(
    "n_out,w",
    [
        (5000, 32),                  # single partial tile, full-width key
        (5000, 31),                  # odd width (16+8+4+2+1 decomposition)
        (PALLAS_TILE, 24),           # exactly one Pallas tile
        (PALLAS_TILE + 1, 23),       # Pallas tile boundary + 1 (halo)
        (3 * PALLAS_TILE + 17, 29),  # multi-tile with ragged tail
        (20000, 12),                 # minimum reference -k
        (9000, 2),                   # minimum Pallas kernel width
    ],
)
def test_window_keys_plain_matches_jax(rng, n_out, w):
    x = rng.integers(0, 4, size=n_out + w - 1).astype(np.uint8)
    hi0, lo0 = jops.window_keys(jnp.asarray(x), w)
    hi1, lo1 = window_keys_pallas(jnp.asarray(x), w, n_out)
    got = window_keys(torch.from_numpy(x), w, n_out).numpy()
    np.testing.assert_array_equal(
        got, keys_from_pair(np.asarray(hi0), np.asarray(lo0))[:n_out]
    )
    np.testing.assert_array_equal(
        got, keys_from_pair(np.asarray(hi1), np.asarray(lo1))
    )


@pytest.mark.parametrize(
    "n_out,w",
    [
        (5000, 32), (5000, 31), (PALLAS_TILE, 24), (PALLAS_TILE + 1, 23),
        (3 * PALLAS_TILE + 17, 29), (20000, 12), (9000, 2),
        (4081, 16),   # whole last word: 4096 codes, W[j+1] past the end
        (33, 32),     # 64 codes in 4 words: W[j+2] past the end at p = 32
        (100, 5),     # partial last word, narrow window
        (1, 1),
    ],
)
def test_window_keys_packed_matches_jax(rng, n_out, w):
    """The packed entry (on the CPU its plain version) and the replay of
    the kernel's word arithmetic, against the JAX package fed the same
    packed words."""
    x = rng.integers(0, 4, size=n_out + w - 1).astype(np.uint8)
    words = pack_2bit_words_host(x)
    x_j = jops.unpack_2bit_words(jnp.asarray(words), n_out + w - 1)
    hi0, lo0 = jops.window_keys(x_j, w)
    want = keys_from_pair(np.asarray(hi0), np.asarray(lo0))[:n_out]
    x2w = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(window_keys_packed(x2w, w, n_out).numpy(), want)
    np.testing.assert_array_equal(
        window_keys_packed_plain(x2w, w, n_out).numpy(), want
    )
    np.testing.assert_array_equal(
        window_keys_words_replay(x2w, w, n_out).numpy(), want
    )
    if w >= 2:      # the Pallas kernel's minimum width
        hi1, lo1 = window_keys_pallas(x_j, w, n_out)
        np.testing.assert_array_equal(
            want, keys_from_pair(np.asarray(hi1), np.asarray(lo1))
        )


def test_window_keys_words_replay_ignores_padding_bits(rng):
    """Keys in [0, n_out) do not depend on the codes of the last word
    past n_out + w - 1, nor on whole words after it."""
    n_out, w = 1000, 29
    n_codes = n_out + w - 1                 # 1028: 4 codes into word 64
    x = rng.integers(0, 4, size=n_codes).astype(np.uint8)
    a = np.concatenate([x, np.zeros(12 + 32, np.uint8)])
    b = np.concatenate([x, np.full(12 + 32, 3, np.uint8)])
    wa = torch.from_numpy(pack_2bit_words_host(a).view(np.int32))
    wb = torch.from_numpy(pack_2bit_words_host(b).view(np.int32))
    want = window_keys(torch.from_numpy(x), w, n_out)
    for words in (wa, wb, wb[:65]):
        assert torch.equal(window_keys_words_replay(words, w, n_out), want)
        assert torch.equal(window_keys_packed(words, w, n_out), want)


def test_window_keys_tail_padding_isolated(rng):
    """Keys in [0, n_out) do not depend on text past n_out + w - 1."""
    n_out, w = 6000, 32
    base = rng.integers(0, 4, size=n_out + w - 1 + 500).astype(np.uint8)
    other = base.copy()
    other[n_out + w - 1 :] = (other[n_out + w - 1 :] + 1) % 4
    a = window_keys(torch.from_numpy(base), w, n_out)
    b = window_keys(torch.from_numpy(other), w, n_out)
    assert torch.equal(a, b)


def test_window_keys_rejects_short_input():
    with pytest.raises(ValueError, match="need"):
        window_keys(torch.zeros(10, dtype=torch.uint8), 8, 5)
    with pytest.raises(ValueError, match="need"):
        window_keys_packed(torch.zeros(2, dtype=torch.int32), 8, 26)
    with pytest.raises(ValueError, match="int32"):
        window_keys_packed(torch.zeros(2, dtype=torch.int64), 8, 5)


@pytest.mark.parametrize("n_codes", [5000, 4096, 37])
@pytest.mark.parametrize("w", [2, 12, 24, 32])
def test_window_keys_at_matches_jax(rng, w, n_codes):
    """The gathered entry (on the CPU its plain version) at random
    positions, in no order and repeated, with the first and the last
    position whose window fits, against the JAX package's keys of every
    window read at those positions (its (hi, lo) pair)."""
    x = rng.integers(0, 4, size=n_codes).astype(np.uint8)
    n_out = n_codes - w + 1
    hi, lo = jops.window_keys(jnp.asarray(x), w)
    want = keys_from_pair(np.asarray(hi), np.asarray(lo))[:n_out]
    pos = np.concatenate([rng.integers(0, n_out, size=300), [n_out - 1, 0, n_out - 1]])
    x2w = torch.from_numpy(pack_2bit_words_host(x).view(np.int32))
    pos_t = torch.from_numpy(pos.astype(np.int64))
    got = window_keys_at(x2w, pos_t, w)
    assert got.dtype == torch.int64 and got.shape == (pos.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want[pos])
    np.testing.assert_array_equal(window_keys_at_plain(x2w, pos_t, w).numpy(),
                                  want[pos])


def test_window_keys_at_reads_zero_past_the_words(rng):
    """A window that runs past the words (or a position before them)
    reads code 0 there, as the kernel's loader does."""
    x = rng.integers(0, 4, size=64).astype(np.uint8)
    x2w = torch.from_numpy(pack_2bit_words_host(x).view(np.int32))
    w = 8
    got = window_keys_at(x2w, torch.tensor([60, 64, -3], dtype=torch.int64), w)
    code = lambda p: int(x[p]) if 0 <= p < 64 else 0  # noqa: E731
    want = [sum(code(p + t) << (2 * (w - 1 - t)) for t in range(w))
            for p in (60, 64, -3)]
    assert got.tolist() == want


def test_window_keys_at_checks_its_arguments():
    x2w = torch.zeros(4, dtype=torch.int32)
    pos = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        window_keys_at(x2w, pos.to(torch.int32), 8)
    with pytest.raises(ValueError, match="int32"):
        window_keys_at(x2w.to(torch.int64), pos, 8)
    with pytest.raises(ValueError, match="window width"):
        window_keys_at(x2w, pos, 33)
    with pytest.raises(ValueError, match="no words"):
        window_keys_at(x2w[:0], pos, 8)
    assert window_keys_at(x2w, pos[:0], 8).shape == (0,)


def _words(rng, R, stop, prefix):
    """Fact bits below `stop` on every row, stop on ~5% of rows plus the
    row the direction requires (last row for suffix, first for prefix)."""
    bits = rng.integers(0, stop, size=R).astype(np.int32)
    is_stop = rng.random(R) < 0.05
    is_stop[0 if prefix else -1] = True
    return bits | (is_stop.astype(np.int32) * np.int32(stop))


def _check_seg_or(words, stop, prefix):
    mask = stop - 1
    w_t = torch.from_numpy(words)
    plain = tseg.seg_scan_or(w_t, stop_bit=stop, prefix=prefix)
    # the kernel's decomposition gives the plain sweep's whole words,
    # whatever its look-backs find
    for lookback in ("inclusive", "aggregate"):
        tiled = tseg.seg_scan_or_tiled(w_t, stop, prefix, lookback)
        assert torch.equal(plain, tiled), lookback
    for impl in ("xla", "pallas"):
        want = np.asarray(
            jax_seg_scan_or(jnp.asarray(words), impl=impl, stop_bit=stop,
                            prefix=prefix)
        ) & mask
        np.testing.assert_array_equal(plain.numpy() & mask, want, err_msg=impl)


@pytest.mark.parametrize("stop", [1 << 6, 1 << 29])
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize(
    "R", [1, 127, T - 1, T, T + 1, T + 2, T + 3, 3 * T + 17,
          PALLAS_TILE + 1, 70001]
)
def test_seg_scan_or_matches_jax(rng, R, prefix, stop):
    """R mod 4 takes every value: T, T + 1, T + 2, T + 3 (and 3T + 17,
    70001), so the ragged tile ends inside a 16-byte chunk."""
    _check_seg_or(_words(rng, R, stop, prefix), stop, prefix)


@pytest.mark.parametrize("stop", [1 << 6, 1 << 29])
@pytest.mark.parametrize("prefix", [False, True])
def test_seg_scan_or_tile_spanning_segment(rng, prefix, stop):
    """One segment across many kernel tiles: the carry crosses every
    tile boundary."""
    R = 5 * PALLAS_TILE + 77
    bits = rng.integers(0, stop, size=R).astype(np.int32)
    bits[0 if prefix else -1] |= stop
    _check_seg_or(bits, stop, prefix)


@pytest.mark.parametrize("lookback", ["inclusive", "aggregate"])
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize(
    "n_tiles,stops",
    [(34, ()),              # one segment: two look-back windows chain
     (67, ()),              # three windows, the last one short
     (40, (3 * T + 5,))],   # a stop inside tile 3 ends the far look-backs
)
def test_seg_scan_or_lookback_chain(rng, n_tiles, stops, prefix, lookback):
    """Segments across more than 32 tiles. With only aggregates
    published, a tile's look-back folds window after window, in order,
    back to tile 0 or to the tile that holds the stop; with inclusive
    prefixes published it ends at the previous tile. Every T-th word
    carries its own pair of bits, so a dropped window shows, and the
    stop shows a fold in the wrong order."""
    stop = 1 << 29
    R = n_tiles * T - 3                     # R mod 4 == 1
    logical = np.zeros(R, np.int32)         # in scan order
    t = np.arange(n_tiles)
    logical[t * T] = (1 << (t % 14)) | (1 << (14 + t // 14))
    logical[0] |= stop
    for k in stops:
        logical[k] |= stop
    words = np.ascontiguousarray(logical if prefix else logical[::-1])
    w_t = torch.from_numpy(words)
    assert torch.equal(
        tseg.seg_scan_or_plain(w_t, stop, prefix),
        tseg.seg_scan_or_tiled(w_t, stop, prefix, lookback),
    )


def test_seg_scan_or_lookback_depth():
    """What the two modes mean for the kernel's look-back: over
    inclusive descriptors it reads one window; over aggregates it reads
    window after window back to tile 0, ceil(t / 32) of them, and folds
    every tile's bit in."""
    stop = 1 << 29
    n_tiles = 70
    value = [1 << (t % 29) for t in range(n_tiles)]
    every = [tseg.INCLUSIVE] * n_tiles
    alone = [tseg.INCLUSIVE] + [tseg.AGGREGATE] * (n_tiles - 1)
    for t in range(1, n_tiles):
        assert tseg._look_back(every, value, t, stop) == (value[t - 1], 1)
        want = 0
        for v in value[:t]:
            want |= v
        assert tseg._look_back(alone, value, t, stop) == (
            want, -(-t // tseg.WINDOW)
        )


def test_seg_scan_or_lookback_stops_at_nearest_inclusive():
    """A descriptor published as inclusive (a tile whose aggregate
    carries STOP) ends the look-back: nothing before it is read, and an
    empty descriptor behind it does not make the look-back wait."""
    stop = 1 << 6
    status = [tseg.EMPTY] * 5 + [tseg.INCLUSIVE] + [tseg.AGGREGATE] * 40
    value = [63] * 5 + [stop | 1] + [2] * 40
    assert tseg._look_back(status, value, 46, stop) == (stop | 3, 2)
    assert tseg._look_back(status, value, 6, stop) == (stop | 1, 1)
    with pytest.raises(AssertionError, match="spin"):
        tseg._look_back(status, value, 5, stop)


def test_seg_scan_or_tiled_rejects_unknown_lookback():
    with pytest.raises(ValueError, match="lookback"):
        tseg.seg_scan_or_tiled(torch.zeros(4, dtype=torch.int32), 64, True, "x")


def test_seg_scan_or_rejects_bad_stop():
    with pytest.raises(ValueError, match="power of two"):
        tseg.seg_scan_or(torch.zeros(4, dtype=torch.int32), stop_bit=3)
    with pytest.raises(ValueError, match="power of two"):
        tseg.seg_scan_or(torch.zeros(4, dtype=torch.int32), stop_bit=1 << 30)


@pytest.mark.parametrize("R", [64, PALLAS_TILE + 13, 2 * PALLAS_TILE])
def test_dist_from_sep_matches_jax(rng, R):
    sep = np.sort(rng.choice(R, size=max(2, R // 50), replace=False))
    sep[-1] = R - 1
    is_sep = np.zeros(R, bool)
    is_sep[sep] = True
    want = np.asarray(jax.jit(jengine._dist_from_sep, static_argnums=1)(
        jnp.asarray(is_sep), R
    ))
    got = tengine._dist_from_sep(torch.from_numpy(is_sep), R).numpy()
    np.testing.assert_array_equal(got, want)
