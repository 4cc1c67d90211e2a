"""The port's CUDA kernels against their plain PyTorch versions, and the
main path on the card. Marked `gpu`: each test skips where no CUDA card
is present (decided in the `cuda` fixture, never at import).

This file imports neither jax nor the JAX package, so on a machine with
a card and no jax it runs without the repo's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.kernels import seg_or
from debwt_tpu_torch.kernels import window_keys as wk
from debwt_tpu_torch.pipeline import build_bwt
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

pytestmark = pytest.mark.gpu

PALLAS_TILE = 8192   # the JAX kernels' tile (tests/test_kernels.py shapes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def gen(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    return g


@pytest.mark.parametrize(
    "n_out,w",
    [(5000, 32), (5000, 31), (PALLAS_TILE, 24), (PALLAS_TILE + 1, 23),
     (3 * PALLAS_TILE + 17, 29), (20000, 12), (9000, 2), (1, 32), (1025, 1)],
)
def test_window_keys_kernel_matches_plain(cuda, gen, n_out, w):
    x = torch.randint(0, 4, (n_out + w - 1,), generator=gen, device=cuda,
                      dtype=torch.uint8)
    before = wk.window_keys.launches
    got = wk.window_keys(x, w, n_out)
    assert wk.window_keys.launches == before + 1
    assert torch.equal(got, wk.window_keys_plain(x, w, n_out))


def test_window_keys_kernel_tail_isolated(cuda, gen):
    n_out, w = 6000, 32
    base = torch.randint(0, 4, (n_out + w - 1 + 500,), generator=gen,
                         device=cuda, dtype=torch.uint8)
    other = base.clone()
    other[n_out + w - 1:] = (other[n_out + w - 1:] + 1) % 4
    assert torch.equal(wk.window_keys(base, w, n_out),
                       wk.window_keys(other, w, n_out))


@pytest.mark.parametrize("stop", [1 << 6, 1 << 29])
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize(
    "R", [1, 127, seg_or.TILE, seg_or.TILE + 1, 3 * seg_or.TILE + 17,
          PALLAS_TILE + 1, 70001, (2 * seg_or.CARRY_THREADS + 5) * seg_or.TILE],
)
@pytest.mark.parametrize("p_stop", [0.05, 0.0])
def test_seg_scan_or_kernel_matches_plain(cuda, gen, R, prefix, stop, p_stop):
    """p_stop = 0: one segment spans every tile (the carry crosses all
    tile boundaries)."""
    bits = torch.randint(0, stop, (R,), generator=gen, device=cuda,
                         dtype=torch.int32)
    is_stop = torch.rand(R, generator=gen, device=cuda) < p_stop
    is_stop[0 if prefix else -1] = True
    words = bits | (is_stop.to(torch.int32) * stop)
    before = seg_or.seg_scan_or.launches
    got = seg_or.seg_scan_or(words, stop_bit=stop, prefix=prefix)
    assert seg_or.seg_scan_or.launches == before + 1
    assert torch.equal(got, seg_or.seg_scan_or_plain(words, stop, prefix))


@pytest.mark.parametrize("m", [12, 24, 32])
def test_build_bwt_on_card_matches_golden(cuda, m):
    rng = np.random.default_rng(m)
    frags = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(4)]
    reads = ["".join(rng.choice(frags) for _ in range(5)) for _ in range(12)]
    coll = SequenceCollection.from_reads(reads)
    wk.window_keys.launches = seg_or.seg_scan_or.launches = 0
    r = build_bwt(coll, PipelineConfig(m=m, check=True))
    assert (wk.window_keys.launches, seg_or.seg_scan_or.launches) == (1, 4)
    g = golden_bwt(coll)
    assert r.packed() == g.packed()
    np.testing.assert_array_equal(r.sharp_pos, g.sharp_pos)
    assert r.dollar_pos == g.dollar_pos
