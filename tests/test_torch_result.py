"""BwtResult.packed() on the CPU: the <obj> bytes made from packed words
on their device (each pair of int32 words swapped into the file's u64
order, fetched once) against golden.pack_2bit_u64, for odd and even
word counts, partial last words and words past the text; and the host
pack where a result holds no words (the out-of-core tier's)."""

import numpy as np
import pytest
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import ops
from debwt_tpu_torch.golden import pack_2bit_u64
from debwt_tpu_torch.pipeline import BwtResult


def _bwt6(n, seed):
    """Random codes 0..3 with '$' at one position and '#' at about a
    seventh of the others."""
    rng = np.random.default_rng(seed)
    x6 = rng.integers(0, 4, n, dtype=np.uint8)
    pos = rng.permutation(n)
    dollar = int(pos[0])
    sharp = np.sort(pos[1 : 1 + n // 7]).astype(np.int64)
    x6[sharp] = K.SHARP
    x6[dollar] = K.DOLLAR
    return x6, sharp, dollar


@pytest.mark.parametrize("pad", [0, 80], ids=["words", "padded_words"])
@pytest.mark.parametrize("n", [1, 15, 16, 31, 32, 33, 47, 64, 1_000_003])
def test_packed_from_words_is_the_file(n, pad):
    """`pad` zero codes after the text stand for the fused engine's
    bucket padding: its words run past ceil(N / 16)."""
    x6, sharp, dollar = _bwt6(n, n + pad)
    codes = torch.zeros(n + pad, dtype=torch.uint8)
    codes[:n] = torch.from_numpy(x6).clamp(max=K.T)
    r = BwtResult(sharp_pos=sharp, dollar_pos=dollar,
                  packed_words=ops.pack_2bit_words(codes), _n=n)
    assert r.packed() == pack_2bit_u64(x6)
    assert r.counters["d2h_bytes"] == 8 * -(-n // 32)
    assert r.counters["syncs"] == 1
    assert r.counters["pack_on_device"] == 1
    np.testing.assert_array_equal(r.bwt6, x6)


def test_packed_without_words_packs_on_the_host():
    x6, sharp, dollar = _bwt6(1001, 7)
    r = BwtResult(sharp_pos=sharp, dollar_pos=dollar, _bwt6=x6, _n=1001)
    assert r.packed() == pack_2bit_u64(x6)
    assert "pack_on_device" not in r.counters
    assert "syncs" not in r.counters and "d2h_bytes" not in r.counters
    assert "packed" in r.timings
