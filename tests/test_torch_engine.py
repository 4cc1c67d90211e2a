"""The port's engine stages against the JAX engine on identical padded
inputs (pipeline.stage_inputs), on the CPU. All data is integer: every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debwt_tpu import engine as jengine
from debwt_tpu_torch import constants as K
from debwt_tpu_torch import engine as tengine
from debwt_tpu_torch import ops
from debwt_tpu_torch.ops import (
    keys_from_pair, pack_2bit_words_host, pair_from_keys,
)
from debwt_tpu_torch.pipeline import (
    BwtResult, _bucket, _char_counts, _pow2, build_bwt, stage_inputs,
)
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

GRAPH_OUT = ("bwt6_partial", "ev_key", "mi_row", "seg_start", "r_pos",
             "bwt_char", "L", "B", "x2p")


@pytest.fixture
def coll():
    # the fixture of tests/test_engine.py
    rng = np.random.default_rng(3)
    frags = ["".join(rng.choice(list("ACGT"), size=25)) for _ in range(4)]
    reads = [
        "".join(rng.choice(frags) for _ in range(4)) for _ in range(4)
    ] + ["".join(rng.choice(list("ACGT"), size=120)) for _ in range(3)]
    return SequenceCollection.from_reads(reads)


def _x2p(coll, N_cap):
    """The T-padded codes pipeline.build_bwt puts on the device."""
    x2p = np.full(N_cap + K.TAIL_PAD, K.T, dtype=np.uint8)
    x2p[: coll.bwt_len] = coll.x2
    return x2p


def _graphs(coll, m):
    """The port's stage_graph fed the T-padded codes, the JAX one the
    same codes as 2-bit words."""
    inp = stage_inputs(coll, m)
    x2p = _x2p(coll, inp.N_cap)
    s_hi, s_lo = pair_from_keys(inp.spec_key)
    j = jengine.stage_graph(
        jnp.asarray(pack_2bit_words_host(x2p)), jnp.asarray(inp.sep_pos),
        jnp.asarray(s_hi), jnp.asarray(s_lo), jnp.asarray(inp.spec_char6),
        jnp.asarray(inp.spec_branch), jnp.int32(inp.n_real), m, inp.N_cap,
    )
    t = tengine.stage_graph(
        torch.from_numpy(x2p),
        torch.from_numpy(inp.sep_pos), torch.from_numpy(inp.spec_key),
        torch.from_numpy(inp.spec_char6), torch.from_numpy(inp.spec_branch),
        inp.n_real, m, inp.N_cap,
    )
    return inp, [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("m", [12, 24, 32])
def test_stage_graph_matches_jax(coll, m):
    """All nine outputs, every row: the graph sort's third key is
    distinct on every row, so its order is fully determined."""
    _inp, j, t = _graphs(coll, m)
    for name, a, b in zip(GRAPH_OUT, j, t):
        if name == "ev_key":
            a = a.astype(np.int64)        # uint32 with SENT 0xFFFFFFFF
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("m", [12, 24, 32])
def test_stage_finish_matches_jax(coll, m):
    """stage_finish of the port and of JAX, each fed the JAX graph
    outputs, and the port's BWT finished by BwtResult.from_bwt6 and
    counted by the check's blockwise count: all six JAX outputs are
    final (BWT, packed words, sidecars, counts), so they agree on every
    row."""
    inp, j, _t = _graphs(coll, m)
    (bwt6_partial, ev_key, mi_row, seg_start, r_pos, bwt_char, L, B, x2p) = j
    L, B = int(L), int(B)
    caps = (m, inp.N_cap, _bucket(L), _bucket(B))
    want = jengine.stage_finish(
        *(jnp.asarray(a) for a in
          (x2p, ev_key, mi_row, seg_start, r_pos, bwt_char, bwt6_partial,
           inp.spec_branch)),
        jnp.int32(inp.n_real), *caps, _pow2(coll.n_reads),
    )
    got = tengine.stage_finish(
        *(torch.from_numpy(np.array(a)) for a in
          (x2p, ev_key.astype(np.int64), mi_row, seg_start, r_pos, bwt_char,
           bwt6_partial, inp.spec_branch)),
        inp.n_real, *caps,
    )
    bwt6, packed, sharp, dollar, n_sharp, counts6 = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got.numpy(), bwt6)
    n = inp.n_real
    r = BwtResult.from_bwt6(got[:n], coll.n_reads)
    words = r.packed_words.numpy().view(np.uint32)
    np.testing.assert_array_equal(words, packed[: words.shape[0]])
    assert not packed[words.shape[0]:].any()     # the bucket padding
    assert int(n_sharp) == r.sharp_pos.shape[0] == coll.n_reads - 1
    np.testing.assert_array_equal(r.sharp_pos, sharp[: int(n_sharp)])
    assert (sharp[int(n_sharp):] == inp.N_cap).all()
    assert r.dollar_pos == int(dollar)
    np.testing.assert_array_equal(_char_counts(got[:n]).numpy(), counts6)


@pytest.mark.parametrize(
    "M,L_dyn,period",
    [(8, 8, 3), (64, 50, 7), (3000, 2900, 41), (5000, 5000, 1), (4000, 1, 1)],
)
def test_suffix_ranks_matches_jax(rng, M, L_dyn, period):
    """Periodic SP strings (long repeats: several tripling rounds) with
    capacity padding past L_dyn; live rows [0, L_dyn) compared."""
    unit = rng.integers(0, 6, size=period).astype(np.uint8)
    sp6 = np.resize(unit, M)
    sp6[L_dyn:] = 0
    sp6[rng.random(M) < 0.001] = 5
    want = np.asarray(jengine._suffix_ranks(jnp.asarray(sp6), jnp.int32(L_dyn)))
    got = tengine._suffix_ranks(torch.from_numpy(sp6), L_dyn).numpy()
    np.testing.assert_array_equal(got[:L_dyn], want[:L_dyn])


def test_spec_keys_convert(coll):
    """stage_inputs' int64 special keys split into the JAX (hi, lo)
    pairs exactly, pad rows included (all ones)."""
    inp = stage_inputs(coll, 32)
    hi, lo = pair_from_keys(inp.spec_key)
    np.testing.assert_array_equal(keys_from_pair(hi, lo), inp.spec_key)
    pad = inp.spec_key == -1
    assert pad.any()
    assert (hi[pad] == 0xFFFFFFFF).all() and (lo[pad] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("m", [12, 24, 32])
@pytest.mark.parametrize("n_reads,length", [(1, 37), (3, 50), (5, 101)])
def test_byte_entry_equals_packed_entry(m, n_reads, length):
    """stage_graph's keys from the uint8 codes equal kernel 1's packed
    entry on pack_2bit_words_host of the same codes, at text lengths
    that are not multiples of 16; and build_bwt uploads the codes once,
    N bytes, beside the four small arrays."""
    rng = np.random.default_rng(m * 100 + length)
    reads = ["".join(rng.choice(list("ACGT"), size=length))
             for _ in range(n_reads)]
    coll = SequenceCollection.from_reads(reads)
    assert coll.bwt_len % 16
    inp = stage_inputs(coll, m)
    x2p = _x2p(coll, inp.N_cap)
    got = ops.window_keys(torch.from_numpy(x2p[: inp.N_cap + m - 1]), m)
    want = ops.window_keys_packed(
        torch.from_numpy(pack_2bit_words_host(x2p).view(np.int32)), m,
        inp.N_cap)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    r = build_bwt(coll, PipelineConfig(m=m), device="cpu")
    small = (inp.sep_pos, inp.spec_key, inp.spec_char6, inp.spec_branch)
    assert r.counters["h2d_bytes"] == coll.bwt_len + sum(
        a.nbytes for a in small)
