"""BwtResult on the CPU: packed(), the <obj> bytes made from packed
words on their device (each pair of int32 words swapped into the
file's u64 order, fetched once) against golden.pack_2bit_u64, for odd
and even word counts, partial last words and words past the text; and
from_bwt6 on a host BWT (the out-of-core tier's): its words, sidecars
and count check."""

import numpy as np
import pytest
import torch

from debwt_tpu_torch import constants as K
from debwt_tpu_torch import ops, tracing
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


def test_from_bwt6_on_a_host_bwt():
    """The words, made on the host, give the file's bytes; the sidecars
    and bwt6 come back; the count check holds the counts and refuses
    one character off."""
    x6, sharp, dollar = _bwt6(1001, 7)
    counts = np.bincount(x6, minlength=6)
    with tracing.recording() as rec:
        r = BwtResult.from_bwt6(torch.from_numpy(x6), sharp.shape[0] + 1,
                                counts)
    assert r.counters is rec.counters and r.timings is rec.timings
    assert r.packed_words.device.type == "cpu"
    assert r.packed() == pack_2bit_u64(x6)
    np.testing.assert_array_equal(r.sharp_pos, sharp)
    assert r.dollar_pos == dollar and isinstance(r.dollar_pos, int)
    np.testing.assert_array_equal(r.bwt6, x6)
    # the sidecars' fetch, the counts' and the pack's
    assert r.counters["syncs"] == 3 and r.counters["pack_on_device"] == 1
    assert "packed" in r.timings
    bad = counts.copy()
    bad[0] -= 1
    bad[1] += 1
    with pytest.raises(AssertionError):
        BwtResult.from_bwt6(torch.from_numpy(x6), sharp.shape[0] + 1, bad)
