"""The port's kernels against the JAX package's, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves run only on the card (tests/test_torch_gpu.py). The
seg-OR kernel's tile decomposition is replayed in torch
(seg_scan_or_tiled) at the kernel's own tile size, so its cross-tile
carry logic is checked here too. JAX runs its Pallas kernels in
interpret mode, as tests/test_kernels.py does. All data is integer:
every comparison is exact.
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
from debwt_tpu_torch.kernels.window_keys import window_keys
from debwt_tpu_torch.ops import keys_from_pair

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
    tiled = tseg.seg_scan_or_tiled(w_t, stop, prefix)
    # the kernel's decomposition gives the plain sweep's whole words
    assert torch.equal(plain, tiled)
    for impl in ("xla", "pallas"):
        want = np.asarray(
            jax_seg_scan_or(jnp.asarray(words), impl=impl, stop_bit=stop,
                            prefix=prefix)
        ) & mask
        np.testing.assert_array_equal(plain.numpy() & mask, want, err_msg=impl)


@pytest.mark.parametrize("stop", [1 << 6, 1 << 29])
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize(
    "R", [1, 127, T, T + 1, 3 * T + 17, PALLAS_TILE + 1, 70001]
)
def test_seg_scan_or_matches_jax(rng, R, prefix, stop):
    _check_seg_or(_words(rng, R, stop, prefix), stop, prefix)


@pytest.mark.parametrize("stop", [1 << 6, 1 << 29])
@pytest.mark.parametrize("prefix", [False, True])
def test_seg_scan_or_tile_spanning_segment(rng, prefix, stop):
    """One segment across many kernel tiles: the carry crosses every
    tile boundary and the carry scan's per-thread runs."""
    R = 5 * PALLAS_TILE + 77
    bits = rng.integers(0, stop, size=R).astype(np.int32)
    bits[0 if prefix else -1] |= stop
    _check_seg_or(bits, stop, prefix)


def test_seg_scan_or_carry_runs_span_threads(rng):
    """More tiles than carry-scan threads, so each thread folds a run of
    several tile aggregates (per > 1), with segments crossing runs."""
    stop = 1 << 6
    R = (2 * tseg.CARRY_THREADS + 5) * T
    words = rng.integers(0, stop, size=R).astype(np.int32)
    is_stop = rng.random(R) < 2e-5
    is_stop[-1] = True
    words |= is_stop.astype(np.int32) * np.int32(stop)
    w_t = torch.from_numpy(words)
    for prefix in (False, True):
        assert torch.equal(
            tseg.seg_scan_or_plain(w_t, stop, prefix),
            tseg.seg_scan_or_tiled(w_t, stop, prefix),
        )


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
