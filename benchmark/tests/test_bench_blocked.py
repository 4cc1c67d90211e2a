"""The reference's blocked suffix sort against its one sort, at blocks
small enough that a text takes many of them: random texts, near-identical
genomes (long common prefixes, many rounds), read sets (duplicate and
reverse-complement reads), the int64 ranks, the control's order, and a
group larger than a block, which raises."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.reference import bwt
from benchmark.traffic import genomes


def _random_text(seed: int, N: int, letters: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, letters, size=N).astype(np.uint8)
    x[rng.random(N) < 0.01] = bwt.SHARP
    x[-1] = bwt.DOLLAR
    return torch.from_numpy(x)


def _text(col: dict, seed: int) -> torch.Tensor:
    codes, lengths = genomes.make_codes(col, seed)
    return bwt.text6(codes, lengths, "cpu")


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
@pytest.mark.parametrize("N,letters,block", [(30, 4, 16), (200, 1, 256),
                                              (700, 4, 32), (2500, 4, 128),
                                              (2500, 2, 256)])
def test_random_texts(seed, N, letters, block):
    x = _random_text(seed, N, letters)
    got = bwt.blocked_suffix_array(x, block=block)
    assert torch.equal(got, bwt.suffix_array(x))


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_near_identical_genomes(seed):
    """Four 2 kb copies at 0.2%: common prefixes of hundreds of
    characters, so the doubling runs to h = 21 * 2^6 and more."""
    x = _text({"model": "uniform", "mbp": 0.008, "genomes": 4,
               "mutation_rate": 0.002}, seed)
    stats = {}
    got = bwt.blocked_suffix_array(x, block=512, stats=stats)
    assert torch.equal(got, bwt.suffix_array(x))
    assert stats["rounds"] >= 6 and stats["rank_bytes"] == 4


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
def test_read_sets(seed):
    """Reads of 60 bases at 12x of a 1.5 kb genome: duplicate reads,
    reverse complements, '#' compared as equal into the next read."""
    col = {"model": "reads", "genome_mbp": 0.0015, "read_len": 60,
           "coverage": 12, "error_rate": 0.002, "rc_share": 0.5}
    codes, lengths = genomes.make_codes(col, seed)
    reads = codes.reshape(-1, 60)
    assert len({r.tobytes() for r in reads}) < reads.shape[0]   # duplicates
    x = bwt.text6(codes, lengths, "cpu")
    got = bwt.blocked_suffix_array(x, block=1024)
    assert torch.equal(got, bwt.suffix_array(x))
    one = bwt.reference_answer(x, blocked=False)
    by_blocks = bwt.reference_answer(x, blocked=True)
    assert torch.equal(one[0], by_blocks[0])
    assert np.array_equal(one[1], by_blocks[1])
    assert np.array_equal(one[2], by_blocks[2])


@pytest.mark.parametrize("seed", [5, 6])
def test_int64_ranks(seed):
    """A lowered limit takes the ranks N >= 2^31 needs."""
    x = _random_text(seed, 1500, 3)
    stats = {}
    got = bwt.blocked_suffix_array(x, block=128, narrow_limit=1000,
                                   stats=stats)
    assert stats["rank_bytes"] == 8
    assert torch.equal(got, bwt.suffix_array(x))


@pytest.mark.parametrize("seed", [1, 2])
def test_the_controls_order(seed):
    """With a depth, ties go by text position on both paths alike."""
    x = _text({"model": "uniform", "mbp": 0.008, "genomes": 4,
               "mutation_rate": 0.002}, seed)
    one = bwt.reference_answer(x, depth=32, blocked=False)
    by_blocks = bwt.reference_answer(x, depth=32, blocked=True)
    assert torch.equal(one[0], by_blocks[0])
    assert np.array_equal(one[1], by_blocks[1])
    assert not torch.equal(one[0], bwt.reference_answer(x, blocked=True)[0])


def test_a_group_larger_than_a_block_raises():
    """400 characters of ACGT repeated: about 95 suffixes share their
    first 21 characters; never sorted in part."""
    x = torch.tensor([0, 1, 2, 3] * 100 + [bwt.DOLLAR], dtype=torch.uint8)
    with pytest.raises(ValueError, match="more than a block of 64"):
        bwt.blocked_suffix_array(x, block=64)
    assert torch.equal(bwt.blocked_suffix_array(x, block=128),
                       bwt.suffix_array(x))


def test_a_group_larger_than_a_block_raises_in_a_round():
    """The first buckets fit, a later group does not."""
    head = torch.zeros(101, dtype=torch.bool)
    head[[0, 90, 100]] = True
    assert bwt._block_end(head, 0, 95, 42) == 90
    with pytest.raises(ValueError, match="10 suffixes share their first 42"):
        bwt._block_end(head, 90, 5, 42)


def test_spans_of_the_text_functions(monkeypatch):
    """text6, bwt_from_sa and the sidecars a few positions at a time
    give what they give at once."""
    col = {"model": "reads", "genome_mbp": 0.001, "read_len": 40,
           "coverage": 3, "error_rate": 0.0, "rc_share": 0.5}
    codes, lengths = genomes.make_codes(col, 8)
    whole = bwt.text6(codes, lengths, "cpu")
    ref = bwt.reference_answer(whole)
    monkeypatch.setattr(bwt, "_SPAN", 7)
    x = bwt.text6(codes, lengths, "cpu")
    assert torch.equal(x, whole)
    sep = np.cumsum(lengths + 1) - 1
    assert (x.numpy()[sep[:-1]] == bwt.SHARP).all() and x[-1] == bwt.DOLLAR
    got = bwt.reference_answer(x)
    assert torch.equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert np.array_equal(got[2], ref[2])


@pytest.mark.parametrize("which,mbp", [("genome", 0.02), ("hap4", 0.02),
                                        ("reads", 0.004)])
def test_the_witness_rehearses_on_the_cpu(capsys, which, mbp):
    """benchmark/witness.py at a cut size: its comparisons hold."""
    from benchmark import witness

    assert witness.main([which, "--device", "cpu", "--mbp", str(mbp)]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got["witness"] == which and got["ok"]


def test_which_path_the_reference_takes():
    assert bwt.one_sort_fits(torch.zeros(1000, dtype=torch.uint8))
    assert not bwt.one_sort_fits(
        torch.zeros(1, dtype=torch.uint8).expand(1 << 31))
    with pytest.raises(ValueError, match="more than 3758096384"):
        bwt.blocked_suffix_array(
            torch.zeros(1, dtype=torch.uint8).expand(bwt.MAX_N + 1))
