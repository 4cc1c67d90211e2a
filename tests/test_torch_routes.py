"""The routing variables DEBWT_SINGLE_MAX_ROWS, DEBWT_FORCE_OOC and
DEBWT_GROUPED_CAP in the port's api.build and GroupedConfig, against
the JAX package's routes (tests/test_grouped.py) and golden, on the CPU
(toy sizes; every comparison exact). Variables are set through
monkeypatch only, so none outlives its test."""

import numpy as np
import pytest
import torch

from debwt_tpu import api as jax_api
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import api, grouped
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.grouped import GroupedConfig, build_bwt_grouped
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

from conftest import random_reads


def _reads():
    return random_reads(np.random.default_rng(3), 6, lo=40, hi=120)


def _jax_build(monkeypatch, reads, m=32):
    """JAX api.build under the same variables; its dist gate is turned
    off as tests/test_grouped.py turns it off (the CPU mesh has 8
    devices)."""
    monkeypatch.setattr(jax_api, "_SINGLE_ROWS", 2)
    return jax_api.build(JaxCollection.from_reads(reads), JaxConfig(m=m))


def _same(got, want):
    assert got.packed() == want.packed()
    np.testing.assert_array_equal(got.sharp_pos, want.sharp_pos)
    assert got.dollar_pos == want.dollar_pos


def test_single_max_rows_routes_grouped(monkeypatch, capsys):
    """A bound under the collection's rows: the grouped tier, with the
    JAX route's bytes."""
    reads = _reads()
    coll = SequenceCollection.from_reads(reads)
    monkeypatch.setenv("DEBWT_SINGLE_MAX_ROWS", "64")
    stats = {}
    r = api.build(coll, PipelineConfig(m=32), device="cpu", verbose=True,
                  stats=stats)
    assert "route: grouped device-resident tier" in capsys.readouterr().err
    assert stats["cap"] == grouped.SCAN_ROWS - 4
    _same(r, _jax_build(monkeypatch, reads))
    _same(r, golden_bwt(coll))


def test_grouped_cap_overflow_goes_out_of_core(monkeypatch, capsys):
    """The all-A read under DEBWT_GROUPED_CAP=256: one node key
    outgrows the group, and the route falls back to the out-of-core
    tier (tests/test_grouped.py::test_api_falls_back_to_ooc_on_overflow)."""
    reads = [np.zeros(3000, dtype=np.uint8)]
    coll = SequenceCollection.from_reads(reads)
    monkeypatch.setenv("DEBWT_SINGLE_MAX_ROWS", "64")
    monkeypatch.setenv("DEBWT_GROUPED_CAP", "256")
    stats = {}
    r = api.build(coll, PipelineConfig(m=32), device="cpu", verbose=True,
                  stats=stats)
    err = capsys.readouterr().err
    assert "grouped tier overflow" in err and "out-of-core chunked tier" in err
    assert "n_buckets" in stats
    _same(r, golden_bwt(coll))
    _same(r, _jax_build(monkeypatch, reads))


def test_force_ooc_skips_the_grouped_tier(monkeypatch, capsys):
    reads = _reads()
    coll = SequenceCollection.from_reads(reads)
    monkeypatch.setenv("DEBWT_SINGLE_MAX_ROWS", "64")
    monkeypatch.setenv("DEBWT_FORCE_OOC", "1")
    stats = {}
    r = api.build(coll, PipelineConfig(m=20), device="cpu", verbose=True,
                  stats=stats)
    err = capsys.readouterr().err
    assert "out-of-core chunked tier" in err and "grouped" not in err
    assert "n_buckets" in stats and "n_groups" not in stats
    _same(r, golden_bwt(coll))
    _same(r, _jax_build(monkeypatch, reads, m=20))
    # under the bound the variable changes nothing
    monkeypatch.delenv("DEBWT_SINGLE_MAX_ROWS")
    r = api.build(coll, PipelineConfig(m=20), device="cpu")
    assert "stage_graph (+h2d, sync)" in r.timings


def _fake_card(monkeypatch, free: int):
    """torch.cuda of a card with `free` bytes free and nothing cached."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (free, free))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 0)


@pytest.mark.parametrize("card_rows,env,fused", [
    (113, None, True),           # the card holds the 112 rows
    (113, "1000000000", True),   # a variable over the card changes nothing
    (112, "1000000000", False),  # nor raises a bound the card sets
    (113, "112", False),         # a variable under the rows lowers it
    (113, "113", True),
])
def test_single_max_rows_never_raises_the_card_bound(monkeypatch, card_rows,
                                                     env, fused):
    coll = SequenceCollection.from_reads(["ACGT" * 10, "TTGCA" * 7])
    assert api.rows_needed(coll, 12) == 112
    _fake_card(monkeypatch, api._BYTES_PER_ROW * card_rows)
    if env is None:
        monkeypatch.delenv("DEBWT_SINGLE_MAX_ROWS", raising=False)
    else:
        monkeypatch.setenv("DEBWT_SINGLE_MAX_ROWS", env)
    went = []
    monkeypatch.setattr(api, "build_bwt",
                        lambda coll, config, device: went.append(("fused", device)))
    monkeypatch.setattr(
        grouped, "build_bwt_grouped",
        lambda coll, config, gcfg, stats, device: went.append(("grouped", device)))
    api.build(coll, PipelineConfig(m=12))
    assert went == [("fused" if fused else "grouped", torch.device("cuda"))]


def test_grouped_cap_variable_lowers_the_default_only(monkeypatch):
    """Unset: default_cap. Set: the smaller of it and the variable. An
    explicit cap wins. On a card, default_cap is what the memory holds,
    and a variable over it changes nothing."""
    cpu, n, chunk = torch.device("cpu"), 10_000, 1024
    monkeypatch.delenv("DEBWT_GROUPED_CAP", raising=False)
    default = grouped.default_cap(cpu, n, chunk)
    assert GroupedConfig().resolved_cap(cpu, n, chunk) == default
    for env, want in (("1000", 1000), (str(default + 8), default)):
        monkeypatch.setenv("DEBWT_GROUPED_CAP", env)
        assert GroupedConfig().resolved_cap(cpu, n, chunk) == want
    assert GroupedConfig(cap=512).resolved_cap(cpu, n, chunk) == 512
    cuda = torch.device("cuda")
    free = (n // 2 + chunk * grouped._SELECT_BYTES_PER_POS
            + 5000 * grouped._GROUP_BYTES_PER_ROW)
    _fake_card(monkeypatch, free)
    assert grouped.default_cap(cuda, n, chunk) == 5000
    for env, want in (("4000", 4000), ("6000", 5000), ("1000000000", 5000)):
        monkeypatch.setenv("DEBWT_GROUPED_CAP", env)
        assert GroupedConfig().resolved_cap(cuda, n, chunk) == want


def test_grouped_cap_variable_reaches_the_build(monkeypatch):
    coll = SequenceCollection.from_reads(_reads())
    monkeypatch.setenv("DEBWT_GROUPED_CAP", "256")
    stats = {}
    r = build_bwt_grouped(coll, PipelineConfig(m=32), stats=stats, device="cpu")
    assert stats["cap"] == 256 and stats["n_groups"] >= 2
    _same(r, golden_bwt(coll))
    stats = {}
    build_bwt_grouped(coll, PipelineConfig(m=32), GroupedConfig(cap=512),
                      stats=stats, device="cpu")
    assert stats["cap"] == 512
