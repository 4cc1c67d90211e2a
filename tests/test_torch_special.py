"""The port's special module (special.build_special) on the CPU: every
SpecialData array against the JAX package's, dtype and values; no
buffer the size of the text, held or made; and the text bytes it
counts."""

import dataclasses
import tracemalloc

import numpy as np
import pytest
import torch

from debwt_tpu.special import build_special as jax_build_special
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import api, special, tracing
from debwt_tpu_torch.constants import MIN_READ_LEN
from debwt_tpu_torch.special import SpecialData, build_special
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

FIELDS = [f.name for f in dataclasses.fields(SpecialData)]


def _bases(rng, size):
    return "".join(rng.choice(list("ACGT"), size=int(size)))


def _random(rng):
    return [_bases(rng, rng.integers(40, 200)) for _ in range(24)]


def _one_read(rng):
    return [_bases(rng, 500)]


def _shortest(rng):
    return [_bases(rng, MIN_READ_LEN) for _ in range(40)]


def _shared_heads(rng):
    """Heads that agree on 50 to 90 bases, so the head ranking takes
    several 21-character rounds. Some heads tie up to a separator that
    the other continues with 'T' (where '#' and '$' must rank above
    'T'), and the last read is the bare prefix of 33, so the ranking
    reads past the end of the text."""
    core = "A" + _bases(rng, 119)
    reads = []
    for i in range(16):
        cut = int(rng.integers(50, 90))
        reads.append(core[:cut] + _bases(rng, rng.integers(0, 60)))
    return reads + [core[:60], core[:60] + "T" * 30 + _bases(rng, 10),
                    core[:MIN_READ_LEN] + "T" * 40, core[:MIN_READ_LEN]]


def _short_last(rng):
    """A last read of 33 bases, whose every window runs past the text."""
    return [_bases(rng, rng.integers(40, 120)) for _ in range(8)] + [
        _bases(rng, MIN_READ_LEN)]


def _repeats(rng):
    """Reads that end alike, so separator windows tie and branch."""
    tail = _bases(rng, 40)
    return [_bases(rng, rng.integers(10, 50)) + tail for _ in range(20)]


CASES = {"random": _random, "one_read": _one_read, "shortest": _shortest,
         "shared_heads": _shared_heads, "short_last": _short_last,
         "repeats": _repeats}


@pytest.mark.parametrize("m", [12, 24, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_build_special_matches_jax(case, m):
    rng = np.random.default_rng(100 * list(CASES).index(case) + m)
    coll = SequenceCollection.from_reads(CASES[case](rng))
    got = build_special(coll, m)
    want = jax_build_special(JaxCollection(x2=coll.x2, sep=coll.sep), m)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_shared_heads_rank_in_several_rounds():
    coll = SequenceCollection.from_reads(
        _shared_heads(np.random.default_rng(0)))
    with tracing.recording() as rec:
        build_special(coll, 32)
    n, k = coll.n_reads, 31
    rounds = (rec.counters["special_text_bytes"] - 4 * n * k - n) // (21 * n)
    assert rounds >= 3


def test_no_module_level_buffer():
    held = [name for name, v in vars(special).items()
            if not name.startswith("__")
            and isinstance(v, (np.ndarray, dict, list))]
    assert held == []


def test_peak_memory_is_not_the_texts():
    n_bases = 16_000_000
    codes = np.random.default_rng(1).integers(0, 4, n_bases, dtype=np.uint8)
    coll = SequenceCollection.from_concat(codes, np.array([n_bases]))
    del codes
    tracemalloc.start()
    try:
        build_special(coll, 32)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak


def _heads_differ_at(n, at, rng):
    """n <= 4 reads that agree on their first `at` bases and differ at
    the next, so the head ranking ends after ceil((at + 1) / 21)
    rounds."""
    core = _bases(rng, at)
    return [core + "ACGT"[i] + _bases(rng, 60) for i in range(n)]


@pytest.mark.parametrize("reads, rounds", [
    (lambda rng: _one_read(rng), 0),
    (lambda rng: _heads_differ_at(4, 0, rng), 1),
    (lambda rng: _heads_differ_at(4, 30, rng), 2),
    (lambda rng: _heads_differ_at(3, 63, rng), 4),
], ids=["one_read", "one_round", "two_rounds", "four_rounds"])
@pytest.mark.parametrize("m", [12, 32])
def test_counts_the_text_bytes_it_reads(reads, rounds, m):
    coll = SequenceCollection.from_reads(reads(np.random.default_rng(m)))
    n, k = coll.n_reads, m - 1
    with tracing.recording() as rec:
        build_special(coll, m)
    assert rec.counters["special_text_bytes"] == (
        n * (2 * k + 1) + 2 * n * k + 21 * n * rounds)


def test_a_build_carries_the_count():
    coll = SequenceCollection.from_reads(_random(np.random.default_rng(2)))
    with tracing.recording() as rec:
        build_special(coll, 32)
    r = api.build(coll, PipelineConfig(m=32), device=torch.device("cpu"))
    assert r.counters["special_text_bytes"] == (
        rec.counters["special_text_bytes"])
