"""The port's ops against the JAX package's and NumPy, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debwt_tpu import ops as jops
from debwt_tpu_torch import ops


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000])
def test_pack_unpack_roundtrip(rng, n):
    x = rng.integers(0, 4, size=n).astype(np.uint8)
    host = ops.pack_2bit_words_host(x)
    np.testing.assert_array_equal(host, jops.pack_2bit_words_host(x))
    words = torch.from_numpy(host.view(np.int32))
    assert torch.equal(ops.unpack_2bit_words(words, n), torch.from_numpy(x))
    # device pack: same uint32 bits as the JAX package's
    dev = ops.pack_2bit_words(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(dev, np.asarray(jops.pack_2bit_words(jnp.asarray(x))))
    np.testing.assert_array_equal(dev, host)


def test_keys_pair_roundtrip(rng):
    hi = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    key = ops.keys_from_pair(hi, lo)
    assert key.dtype == np.int64
    assert (key < 0).any()            # top bit set on some keys
    h2, l2 = ops.pair_from_keys(key)
    np.testing.assert_array_equal(h2, hi)
    np.testing.assert_array_equal(l2, lo)


def _keys(rng, n, dtypes):
    out = []
    for dt in dtypes:
        if dt == "i32":
            out.append(rng.integers(-(1 << 31), 1 << 31, size=n).astype(np.int32) // (1 << 28))
        else:
            out.append(rng.integers(-(1 << 62), 1 << 62, size=n) // (1 << 59))
    return out


@pytest.mark.parametrize(
    "dtypes",
    [("i32",), ("i64",), ("i32", "i32"), ("i64", "i32"),
     ("i32", "i32", "i32"), ("i32", "i64", "i32", "i32")],
)
def test_msort_matches_lexsort(rng, dtypes):
    """Small key ranges force many ties; the payload (row index) must
    come out in an order consistent with np.lexsort's key order."""
    n = 3000
    keys = _keys(rng, n, dtypes)
    payload = np.arange(n, dtype=np.int32)
    order = np.lexsort(tuple(reversed(keys)))
    got = ops.msort(
        tuple(torch.from_numpy(k) for k in keys) + (torch.from_numpy(payload),),
        num_keys=len(keys),
    )
    for g, k in zip(got, keys):
        np.testing.assert_array_equal(g.numpy(), k[order])
    # stable passes: ties keep input order, exactly as np.lexsort does
    np.testing.assert_array_equal(got[-1].numpy(), payload[order])


def test_window_keys_rejects_bad_width():
    with pytest.raises(ValueError):
        ops.window_keys(torch.zeros(40, dtype=torch.uint8), 33)


@pytest.mark.parametrize("n,n_words,lead", [(100, 9, 1), (95, 6, 0), (1, 2, 1),
                                            (250, 20, 0)])
def test_pack_text_is_the_host_pack_of_the_padded_codes(rng, monkeypatch, n,
                                                         n_words, lead):
    """pack_text, a block of 32 codes at a time: `lead` words of T's,
    then the host pack of the codes and the T's after them; pack_codes
    clamps a BWT's '#' and '$' to 3 as it packs."""
    monkeypatch.setattr(ops, "PACK_BLOCK", 32)
    x = rng.integers(0, 4, size=n).astype(np.uint8)
    want = np.full(16 * n_words, 3, np.uint8)
    want[16 * lead : 16 * lead + n] = x
    got = ops.pack_text(x, n_words, "cpu", lead=lead).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ops.pack_2bit_words_host(want))
    six = rng.integers(0, 6, size=n).astype(np.uint8)
    out = torch.empty(-(-n // 16), dtype=torch.int32)
    ops.pack_codes(torch.from_numpy(six), out)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  ops.pack_2bit_words_host(np.minimum(six, 3)))
