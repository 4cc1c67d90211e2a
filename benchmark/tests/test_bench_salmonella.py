"""The salmonella50_243.fused cell on the CPU: found by name with its metrics,
the fused engine's finishing-stage readers on hand-made traces, and its
generator at a small size through api.build against the plain reference."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import harness
from benchmark.measure import trace
from benchmark.reference import bwt
from benchmark.traffic import genomes

CELL = "salmonella50_243.fused"
# read here and in dmel_140.fused: the finishing stage's parts
NEW = ["fused.sp_sort_s", "fused.rank_s", "fused.rank_rounds"]
# accepted readers of any fused build, this cell appended to their lists
SHARED = ["special.host_s", "fused.graph_s", "fused.finish_s",
          "fused.inputs_s", "fused.wait_s", "fused.syncs", "result.pack_s",
          "result.fetch_s", "result.assemble_s", "kernel.window_keys_pct",
          "kernel.seg_or_pct", "device.idle_pct.build",
          "device.idle_traced_pct.build"]
CPU = torch.device("cpu")


def test_the_cell_resolves_with_its_metrics():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["entry"] == "library"
    assert cell.traffic["m"] == 32 and cell.traffic["checked_share"] == 0.1
    assert cell.config["collection"] == {
        "model": "uniform", "mbp": 242.8725, "genomes": 50,
        "mutation_rate": 0.001}
    assert cell.config["reduced"] == {}
    e2e = {m["name"] for m in cell.metrics["end_to_end"]}
    assert {"build_mbps", "peak_device_gb", "host_peak_rss_gb",
            "setup_s"} <= e2e and "job_mbps" not in e2e
    per_layer = {m["name"]: m for m in cell.metrics["per_layer"]}
    assert set(per_layer) == set(NEW + SHARED)
    for name in NEW + SHARED:
        assert per_layer[name]["moves"] == "build_mbps"
        assert callable(harness.load_reader(name))
    for name in NEW:
        assert per_layer[name]["workloads"] == [CELL, "dmel_140.fused"]
        assert per_layer[name]["layer"] == "fused engine"
    for name in SHARED:
        assert per_layer[name]["workloads"][-1] == CELL
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}["salmonella50_243"]
    assert conf["reduced"] == [] and conf["source"] == cell.config["source"]


def test_whole_collection_takes_the_fused_route_on_an_h100():
    """50 genomes of 4,857,450 bases: R = _bucket(N) + _pow2(50 * 31)
    rows, under 2^29 and, at the fused engine's bytes a row, well under
    an 80 GB card's memory."""
    from debwt_tpu_torch import api
    from debwt_tpu_torch.pipeline import _bucket, _pow2

    col = harness.load_cell(CELL).config["collection"]
    per = int(col["mbp"] * 1e6) // col["genomes"]
    assert per == 4_857_450
    N = per * col["genomes"] + col["genomes"]
    rows = _bucket(N) + _pow2(col["genomes"] * 31)
    assert rows == 268_437_504 < api._SINGLE_ROWS
    assert rows * api._BYTES_PER_ROW < 0.6 * 80e9


def _window(program, n_builds=2):
    t = trace.Trace(window_s=10.0, device=[], spans=[], host_ops=[])
    t.program = program
    return types.SimpleNamespace(trace=t, builds=[{}] * n_builds)


# two fused builds: three rank rounds, then one
PROGRAM = [
    ("debwt.build", 0.0, 4.0),
    ("debwt.fused", 0.0, 4.0),
    ("debwt.finish", 1.0, 3.0),
    ("debwt.finish.sp", 1.0, 1.5),
    ("debwt.finish.enqueue", 1.0, 1.25),
    ("debwt.finish.wait", 1.25, 1.5),
    ("debwt.finish.rank", 1.5, 2.5),
    ("debwt.finish.enqueue", 1.5, 1.75),
    ("debwt.finish.wait", 1.75, 2.0),
    ("debwt.finish.wait", 2.0, 2.25),
    ("debwt.finish.wait", 2.25, 2.5),
    ("debwt.finish.blue", 2.5, 2.75),
    ("debwt.finish.wait", 2.75, 3.0),
    ("debwt.pack", 4.0, 5.0),
    ("debwt.pack.wait", 4.0, 4.5),
    ("debwt.build", 5.0, 7.0),
    ("debwt.finish.sp", 5.0, 5.25),
    ("debwt.finish.wait", 5.125, 5.25),
    ("debwt.finish.rank", 5.25, 5.5),
    ("debwt.finish.wait", 5.25, 5.5),
    ("debwt.finish.blue", 5.5, 6.0),
]
WANT = {
    "fused.sp_sort_s": (0.5 + 0.25) / 2,
    "fused.rank_s": (1.0 + 0.25) / 2,
    "fused.rank_rounds": (3 + 1) / 2,
}


@pytest.mark.parametrize("name", NEW)
def test_span_readers_read_the_mean(name):
    assert harness.load_reader(name)(_window(PROGRAM)) == \
        pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_the_spans(name):
    read = harness.load_reader(name)
    assert read(_window([])) is None
    assert read(types.SimpleNamespace(trace=None, builds=[{}])) is None
    # a fused build whose finishing stage has no parts (the parent's)
    assert read(_window([("debwt.build", 0.0, 1.0),
                         ("debwt.finish", 0.25, 0.75),
                         ("debwt.finish.enqueue", 0.25, 0.5),
                         ("debwt.finish.wait", 0.5, 0.75),
                         ("debwt.pack", 1.0, 2.0)])) is None


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_generator_through_api_build_is_the_reference(seed, capsys):
    """The cell's generator at 1 Mbp (50 genomes of 20 kb) with a build's
    substitution, through api.build on the fused route: the plain
    reference's answer, every number 0, with several rank rounds."""
    from debwt_tpu_torch import api
    from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

    col = dict(harness.load_cell(CELL).config["collection"], mbp=1.0)
    codes, lengths = genomes.make_codes(col, seed)
    assert lengths.tolist() == [20_000] * 50
    q, shift = genomes.substitution(seed, 1, codes.shape[0])
    codes[q] = (codes[q] + shift) % 4
    res = api.build(SequenceCollection.from_concat(codes, lengths),
                    PipelineConfig(m=32), device=CPU, verbose=True)
    assert "route: single-device fused engine" in capsys.readouterr().err
    assert res.counters["rank_rounds"] > 1
    ans = bwt.Answer(res.packed(), res.sharp_pos, res.dollar_pos)
    got = bwt.compare(ans, bwt.reference_answer(bwt.text6(codes, lengths, CPU)))
    assert got == {"obj_bytes_off": 0, "sharp_off": 0, "dollar_off": 0}
