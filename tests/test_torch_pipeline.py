"""The port's build_bwt end to end, on the CPU: byte parity with the
JAX package's build_bwt and with golden.golden_bwt on the read
generators of tests/test_pipeline.py, and the reference binary's
hashes of the 4.6 Mbp synthetic collection (.bench_cache.json)."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from debwt_tpu.golden import golden_bwt
from debwt_tpu.pipeline import build_bwt as jax_build_bwt
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import api
from debwt_tpu_torch.pipeline import build_bwt
from debwt_tpu_torch.synth import synth_collection
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _assert_equal(reads, m=32, against_jax=True):
    coll = SequenceCollection.from_reads(reads)
    r = build_bwt(coll, PipelineConfig(m=m, check=True), device="cpu")
    g = golden_bwt(JaxCollection(x2=coll.x2, sep=coll.sep))
    np.testing.assert_array_equal(r.bwt6, g.bwt6)
    np.testing.assert_array_equal(r.sharp_pos, g.sharp_pos)
    assert r.dollar_pos == g.dollar_pos
    assert r.packed() == g.packed()
    if against_jax:
        j = jax_build_bwt(JaxCollection(x2=coll.x2, sep=coll.sep),
                          JaxConfig(m=m, check=True))
        assert r.packed() == j.packed()
        np.testing.assert_array_equal(r.sharp_pos, j.sharp_pos)
        assert r.dollar_pos == j.dollar_pos
        np.testing.assert_array_equal(r.bwt6, j.bwt6)


def _rand(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.mark.parametrize("seed,n_reads", [(0, 1), (1, 3), (2, 6), (3, 12)])
def test_random(seed, n_reads):
    rng = np.random.default_rng(seed)
    _assert_equal([_rand(rng, int(rng.integers(40, 200))) for _ in range(n_reads)])


@pytest.mark.parametrize("m", [12, 16, 24, 31, 32])
def test_k_sweep_vs_jax(m):
    rng = np.random.default_rng(m)
    _assert_equal([_rand(rng, int(rng.integers(40, 150))) for _ in range(4)], m)


@pytest.mark.parametrize("m", range(12, 33))
def test_k_sweep_vs_golden(m):
    """Every m of the reference's -k range: BWT, sidecars and '$'."""
    rng = np.random.default_rng(100 + m)
    frags = [_rand(rng, int(rng.integers(15, 60))) for _ in range(4)]
    reads = ["".join(rng.choice(frags) for _ in range(4)) for _ in range(5)]
    reads += [_rand(rng, int(rng.integers(40, 150))) for _ in range(3)]
    _assert_equal(reads, m)


@pytest.mark.parametrize("seed", range(4))
def test_repeat_heavy(seed):
    rng = np.random.default_rng(seed)
    frags = [_rand(rng, int(rng.integers(15, 60))) for _ in range(5)]
    reads = [
        "".join(rng.choice(frags) for _ in range(int(rng.integers(3, 7))))
        for _ in range(int(rng.integers(3, 8)))
    ]
    _assert_equal(reads)


@pytest.mark.parametrize("m", [12, 20])
def test_homopolymer_small_m(m):
    """L_cap/B_cap past R: every position is a branch event."""
    rng = np.random.default_rng(m)
    reads = [
        "A" * 100,
        "A" * 50 + "C" + "A" * 33,
        "T" * 60 + "A" + "T" * 40,
        _rand(rng, 50),
    ]
    _assert_equal(reads, m)


def test_low_complexity_and_duplicates():
    rng = np.random.default_rng(7)
    base = [_rand(rng, int(rng.integers(40, 90))) for _ in range(8)]
    reads = ["A" * 100 + "C" + "A" * 50, "AC" * 40 + "G", "ACG" * 30]
    _assert_equal(reads + base + base[:4])


def test_bench_collection_matches_reference_hashes():
    """The 4.6 Mbp synthetic collection (the copy of bench.synth_reads)
    reproduces the reference binary's output hashes."""
    ref = json.loads((ROOT / ".bench_cache.json").read_text())["ref_mbp4.6"]
    coll = synth_collection(4.6)
    r = build_bwt(coll, PipelineConfig(m=32), device="cpu")
    assert hashlib.sha256(r.packed()).hexdigest() == ref["obj_sha"]
    sharp = r.sharp_pos.astype(np.int64).tobytes()
    assert hashlib.sha256(sharp).hexdigest() == ref["sharp_sha"]
    assert r.dollar_pos == ref["dollar"]


def test_default_device_needs_a_card(monkeypatch):
    """Without device=, build_bwt runs on the card; with no card it
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coll = SequenceCollection.from_reads(["ACGT" * 10, "TTGCA" * 9])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bwt(coll)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build(coll)


def test_api_routes_single_and_refuses_larger(monkeypatch):
    """Under the bound: the fused engine. Over it: the grouped tier,
    the same bytes. Over the grouped tier's position bound, which the
    grouped tier refuses: the out-of-core tier, the same bytes."""
    from debwt_tpu_torch import grouped

    rng = np.random.default_rng(1)
    coll = SequenceCollection.from_reads([_rand(rng, 80) for _ in range(3)])
    g = golden_bwt(JaxCollection(x2=coll.x2, sep=coll.sep))
    r = api.build(coll, device="cpu")
    assert r.packed() == g.packed() and "stage_graph (+h2d, sync)" in r.timings
    monkeypatch.setattr(api, "_SINGLE_ROWS", 64)
    r = api.build(coll, device="cpu")
    assert r.packed() == g.packed() and "groups.select" in r.timings
    monkeypatch.setattr(grouped, "MAX_N", 100)
    r = api.build(coll, device="cpu")
    assert r.packed() == g.packed() and "pass B (bucket sorts)" in r.timings


@pytest.mark.parametrize(
    "free_memory,fits",
    [(80 * 2**30, True),                    # a whole card: the tiny input fits
     (api._BYTES_PER_ROW * 113, True),       # holds 113 rows: 112 < 113
     (api._BYTES_PER_ROW * 113 - 1, False),  # holds 112 rows: one too few
     (1, False)],
)
def test_api_bounds_single_tier_by_card_memory(monkeypatch, free_memory, fits):
    """On a CUDA device a collection whose rows exceed what the card's
    memory holds goes to the grouped tier before anything is allocated
    (not into an out-of-memory error from the fused engine), and to the
    out-of-core tier where the grouped tier cannot take it."""
    from debwt_tpu_torch import grouped, oocore

    coll = SequenceCollection.from_reads(["ACGT" * 10, "TTGCA" * 7])
    assert api.rows_needed(coll, 12) == 112   # _bucket(77) = 80, _pow2(22) = 32
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(api, "resolve_device", lambda device=None: cuda)
    monkeypatch.setattr(api, "_device_memory_bytes", lambda dev: free_memory)
    built = []
    monkeypatch.setattr(
        api, "build_bwt", lambda coll, config, device: built.append(device)
    )
    went = []
    monkeypatch.setattr(
        grouped, "build_bwt_grouped",
        lambda coll, config, gcfg, stats, device: went.append(device),
    )
    api.build(coll, PipelineConfig(m=12))
    assert (built, went) == (([cuda], []) if fits else ([], [cuda]))
    if not fits:
        monkeypatch.setattr(grouped, "MAX_N", coll.bwt_len)
        ooc = []
        monkeypatch.setattr(
            oocore, "build_bwt_ooc",
            lambda coll, config, stats, device: ooc.append(device),
        )
        api.build(coll, PipelineConfig(m=12))
        assert (built, went, ooc) == ([], [cuda], [cuda])


def test_single_rows_bound_is_the_smaller_of_engine_and_memory(monkeypatch):
    monkeypatch.setattr(api, "_device_memory_bytes", lambda dev: 1 << 62)
    assert api.single_rows_bound(torch.device("cuda")) == api.MAX_ROWS
    monkeypatch.setattr(
        api, "_device_memory_bytes", lambda dev: 1000 * api._BYTES_PER_ROW
    )
    assert api.single_rows_bound(torch.device("cuda")) == 1000
    # the CPU is not asked for its memory
    monkeypatch.setattr(api, "_device_memory_bytes", lambda dev: 1 / 0)
    assert api.single_rows_bound(torch.device("cpu")) == api.MAX_ROWS
