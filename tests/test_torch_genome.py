"""What the port needs at genome scale, on the CPU at toy sizes: its copy
of tools/bench_ooc.py's synth_concat (the input of the JAX package's
1 and 3 Gbp rows in .bench_cache.json), that collection through the
grouped tier against the JAX tier and golden, the reference-format
files with positions past 2^31 and 2^32 against the JAX writer, the
blocked 2-bit packers and the blocked character-count check. All data
is integer: every comparison is exact."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from debwt_tpu import grouped as jgrouped
from debwt_tpu.golden import pack_2bit_u64 as jax_pack
from debwt_tpu.io.writer import write_bwt as jax_write_bwt
from debwt_tpu.pipeline import BwtResult as JaxResult
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import constants as K
from debwt_tpu_torch import golden, pipeline
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.grouped import GroupedConfig, build_bwt_grouped
from debwt_tpu_torch.io import read_bwt, read_sidecars, write_bwt
from debwt_tpu_torch.pipeline import BwtResult
from debwt_tpu_torch.synth import synth_concat_codes, synth_concat_collection
from debwt_tpu_torch.types import PipelineConfig

BENCH_OOC = Path(__file__).resolve().parent.parent / "tools" / "bench_ooc.py"


@pytest.fixture
def bench_ooc(monkeypatch):
    """tools/bench_ooc.py imported by path; what its import sets in
    sys.path and the environment is undone afterwards."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    spec = importlib.util.spec_from_file_location("_bench_ooc", BENCH_OOC)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mbp", [0.01, 0.3, 2.0])
def test_synth_concat_codes_match_bench_ooc(bench_ooc, mbp, seed):
    codes, lengths = synth_concat_codes(mbp, seed)
    want_codes, want_lengths = bench_ooc.synth_concat(mbp, seed)
    assert codes.dtype == np.uint8 and lengths.dtype == np.int64
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(lengths, want_lengths)


@pytest.mark.parametrize("mbp,seed,cap,chunk", [(0.004, 0, 1024, 512),
                                                (0.006, 1, 1536, 1024)])
def test_synth_concat_through_grouped_matches_jax_and_golden(mbp, seed, cap, chunk):
    """A few thousand bases of synth_concat in three or more groups: the
    port's grouped tier builds the JAX tier's and golden's BWT, with the
    same SP length and blue count (the counts the 3 Gbp build is held
    to)."""
    coll = synth_concat_collection(mbp, seed)
    stats, jstats = {}, {}
    got = build_bwt_grouped(coll, PipelineConfig(m=32, check=True),
                            GroupedConfig(cap=cap, chunk=chunk), stats=stats,
                            device="cpu")
    want = jgrouped.build_bwt_grouped(
        JaxCollection(x2=coll.x2, sep=coll.sep), JaxConfig(m=32, check=True),
        jgrouped.GroupedConfig(cap=cap, chunk=chunk), stats=jstats)
    gold = golden_bwt(coll)
    assert stats["n_groups"] >= 3 and stats["n_chunks"] >= 2
    assert (stats["sp_len"], stats["n_blue"]) == (jstats["sp_len"], jstats["n_blue"])
    assert stats["sp_len"] > 0 and stats["n_blue"] > 0
    for ref in (want, gold):
        assert got.packed() == ref.packed()
        np.testing.assert_array_equal(got.sharp_pos, ref.sharp_pos)
        assert got.dollar_pos == ref.dollar_pos


@pytest.mark.parametrize("sharp,dollar", [
    ([3, 2**31, 2**31 + 5, 2**32 + 9], 2**32 + 17),
    ([2**31 - 1], 2**31),
    ([], 2**32),
])
def test_sidecars_past_2_32_match_the_jax_writer(tmp_path, sharp, dollar):
    """`.#` and `.$` hold positions past 2^31 and 2^32 as u64: the same
    bytes as the JAX writer's, read back by read_sidecars (read_bwt's
    reader of them) to the same values."""
    bwt6 = np.random.default_rng(len(sharp)).integers(0, 4, 77, dtype=np.uint8)
    bwt6[0] = K.DOLLAR
    sharp = np.asarray(sharp, dtype=np.int64)
    # a one-read result whose sidecars are then set past 2^32
    r = BwtResult.from_bwt6(torch.from_numpy(bwt6), 1)
    write_bwt(dataclasses.replace(r, sharp_pos=sharp, dollar_pos=dollar),
              str(tmp_path / "p.bwt"))
    jax_write_bwt(JaxResult(sharp_pos=sharp, dollar_pos=dollar, _bwt6=bwt6, _n=77),
                  str(tmp_path / "j.bwt"))
    for ext in ("", ".#", ".$"):
        assert ((tmp_path / f"p.bwt{ext}").read_bytes()
                == (tmp_path / f"j.bwt{ext}").read_bytes())
    got_sharp, got_dollar = read_sidecars(str(tmp_path / "p.bwt"))
    assert got_sharp.dtype == np.int64
    np.testing.assert_array_equal(got_sharp, sharp)
    assert got_dollar == dollar and isinstance(got_dollar, int)


def test_read_bwt_round_trip(tmp_path):
    coll = synth_concat_collection(0.004, 3)
    g = golden_bwt(coll)
    write_bwt(g, str(tmp_path / "o.bwt"))
    bwt6, sharp, dollar = read_bwt(str(tmp_path / "o.bwt"), coll.bwt_len)
    np.testing.assert_array_equal(bwt6, g.bwt6)
    np.testing.assert_array_equal(sharp, g.sharp_pos)
    assert dollar == g.dollar_pos


@pytest.mark.parametrize("block", [64, 1 << 26])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, (1 << 12) + 5])
def test_packers_match_jax(monkeypatch, n, block):
    """The blocked packers give the JAX packer's bytes, also over several
    blocks; a 6-letter BWT packs with its separators as T."""
    monkeypatch.setattr(golden, "_PACK_BLOCK", block)
    bwt6 = np.random.default_rng(n).integers(0, 6, n, dtype=np.uint8)
    bwt2 = np.minimum(bwt6, 3)
    raw = golden.pack_2bit_u64(bwt6)
    assert raw == golden.pack_2bit_u64(bwt2) == jax_pack(bwt2)
    np.testing.assert_array_equal(golden.unpack_2bit_u64(raw, n), bwt2)


@pytest.mark.parametrize("block", [7, 64, 1 << 26])
def test_char_counts_blocked(monkeypatch, block):
    monkeypatch.setattr(pipeline, "_COUNT_BLOCK", block)
    a = np.random.default_rng(block).integers(0, 6, 1001, dtype=np.uint8)
    np.testing.assert_array_equal(pipeline.char_counts(a),
                                  np.bincount(a, minlength=6))


def test_check_char_counts_holds_the_text():
    """The finisher's check (BwtResult.from_bwt6 against
    expected_char_counts) passes golden's BWT and fails one character
    off, and expected_char_counts counts x6 without its copy."""
    coll = synth_concat_collection(0.004, 2)
    g = golden_bwt(coll)
    want = pipeline.expected_char_counts(coll)
    BwtResult.from_bwt6(torch.from_numpy(g.bwt6), coll.n_reads, want)
    np.testing.assert_array_equal(want, np.bincount(coll.x6, minlength=6))
    bad = g.bwt6.copy()
    bad[int(np.nonzero(bad == 0)[0][0])] = 1
    with pytest.raises(AssertionError):
        BwtResult.from_bwt6(torch.from_numpy(bad), coll.n_reads, want)
