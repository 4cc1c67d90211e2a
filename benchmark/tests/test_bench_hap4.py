"""The hap4_1000.grouped cell on the CPU: found by name with its metrics,
its span readers on hand-made traces, and its generator at a small size
through the grouped tier against the plain reference."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import harness
from benchmark.measure import trace
from benchmark.reference import bwt
from benchmark.traffic import genomes

CELL = "hap4_1000.grouped"
# read only here: the grouped tier's own spans
NEW = ["grouped.text_s", "grouped.groups_s", "sp_rank.grouped_s",
       "grouped.fill_s", "pack.grouped_s"]
# read in the fused cell too, and in this one
SHARED = ["special.host_s", "fused.wait_s", "fused.syncs", "result.fetch_s",
          "result.assemble_s", "device.idle_pct.build",
          "device.idle_traced_pct.build"]
CPU = torch.device("cpu")


def test_the_cell_resolves_with_its_metrics():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["entry"] == "library"
    assert cell.config["collection"] == {
        "model": "uniform", "mbp": 1000.0, "genomes": 4,
        "mutation_rate": 0.002}
    e2e = {m["name"] for m in cell.metrics["end_to_end"]}
    assert {"build_mbps", "peak_device_gb", "host_peak_rss_gb",
            "setup_s"} <= e2e and "job_mbps" not in e2e
    per_layer = {m["name"]: m for m in cell.metrics["per_layer"]}
    assert set(per_layer) == set(NEW + SHARED)
    for name in NEW + SHARED:
        cells = per_layer[name]["workloads"]
        assert CELL in cells and (cells == [CELL]) == (name in NEW)
        assert per_layer[name]["moves"] == "build_mbps"
        assert callable(harness.load_reader(name))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}["hap4_1000"]
    assert conf["reduced"] == list(cell.config["reduced"])


def _window(program, n_builds=2, device=(), timings=()):
    t = trace.Trace(window_s=10.0, device=list(device), spans=[],
                    host_ops=[])
    t.program = program
    builds = [{"timings": dict(timings)} for _ in range(n_builds)]
    return types.SimpleNamespace(trace=t, builds=builds)


# two grouped builds; the device busy [1.5, 2), [3.25, 3.5), [5.5, 6)
PROGRAM = [
    ("debwt.build", 0.0, 4.0),
    ("debwt.grouped", 0.0, 4.0),
    ("debwt.grouped.special", 0.1, 0.5),
    ("debwt.grouped.text", 0.5, 1.0),
    ("debwt.grouped.groups", 1.0, 3.0),
    ("debwt.grouped.select", 1.0, 1.5),
    ("debwt.grouped.select.wait", 1.25, 1.5),
    ("debwt.grouped.classify", 1.5, 2.0),
    ("debwt.grouped.rows", 2.0, 3.0),
    ("debwt.grouped.rows.wait", 2.0, 2.5),
    ("debwt.grouped.sp", 3.0, 3.5),
    ("debwt.rank.wait", 3.25, 3.5),
    ("debwt.grouped.fill", 3.5, 3.75),
    ("debwt.grouped.fill", 3.75, 4.0),
    ("debwt.grouped.fill.wait", 3.75, 4.0),
    ("debwt.pack", 4.0, 5.0),
    ("debwt.pack.wait", 4.0, 4.5),
    ("debwt.pack.assemble", 4.5, 5.0),
    ("debwt.build", 5.0, 7.0),
    ("debwt.grouped.text", 5.0, 6.0),
    ("debwt.grouped.groups", 6.0, 7.0),
    ("debwt.grouped.rows.wait", 6.0, 6.5),
]
WANT = {
    "grouped.text_s": (0.5 + 1.0) / 2,
    "grouped.groups_s": (2.0 + 1.0) / 2,
    "sp_rank.grouped_s": 0.5 / 2,
    "grouped.fill_s": 0.5 / 2,
    "pack.grouped_s": 1.0 / 2,
    # the accepted readers this cell is listed on, on its spans
    "fused.wait_s": (0.25 + 0.5 + 0.25 + 0.25 + 0.5) / 2,
    "fused.syncs": (5 + 1) / 2,
    "result.fetch_s": 0.5 / 2,
    "result.assemble_s": 0.5 / 2,
    "special.host_s": 0.4,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_read_the_mean(name):
    read = harness.load_reader(name)
    w = _window(PROGRAM, timings={"special module (host)": 0.4})
    assert read(w) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_the_spans(name):
    read = harness.load_reader(name)
    assert read(_window([])) is None
    assert read(types.SimpleNamespace(trace=None, builds=[{}])) is None
    # a program without the grouped tier's spans (the parent's)
    if name != "pack.grouped_s":
        assert read(_window([("debwt.build", 0.0, 1.0),
                             ("debwt.pack", 1.0, 2.0)])) is None


def test_idle_shares_on_a_hand_made_trace():
    busy = [("k", 1.5, 2.0), ("k", 3.25, 3.5), ("k", 5.5, 6.0)]
    w = _window(PROGRAM, device=busy)
    assert harness.load_reader("device.idle_pct.build")(w) == \
        pytest.approx(100 * (1 - 1.25 / 10))
    # idle outside the program: [7, 10); in build's own time: none
    assert harness.load_reader("device.idle_traced_pct.build")(w) == \
        pytest.approx(100 * (10 - 1.25 - 3.0) / (10 - 1.25))


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_generator_through_the_grouped_tier_is_the_reference(seed):
    """The cell's generator at 0.2 Mbp (four 50 kb haplotypes) with a
    build's substitution, built by the grouped tier in at least three
    groups: the plain reference's answer, every number 0."""
    from debwt_tpu_torch.grouped import GroupedConfig, build_bwt_grouped
    from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

    col = dict(harness.load_cell(CELL).config["collection"], mbp=0.2)
    codes, lengths = genomes.make_codes(col, seed)
    q, shift = genomes.substitution(seed, 1, codes.shape[0])
    codes[q] = (codes[q] + shift) % 4
    stats = {}
    res = build_bwt_grouped(
        SequenceCollection.from_concat(codes, lengths), PipelineConfig(m=32),
        GroupedConfig(cap=80_000, chunk=1 << 14), stats=stats, device=CPU)
    assert stats["n_groups"] >= 3 and res.packed_words is not None
    ans = bwt.Answer(res.packed(), res.sharp_pos, res.dollar_pos)
    got = bwt.compare(ans, bwt.reference_answer(bwt.text6(codes, lengths, CPU)))
    assert got == {"obj_bytes_off": 0, "sharp_off": 0, "dollar_off": 0}
