"""The harness end to end at a tiny size on the CPU: cells found by name,
the result line, and a cell added by new files alone."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from benchmark import harness

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, name, trace=False, seconds=0.3, seed=2**31 + 11):
    return harness.run_cell(harness.load_cell(name, root), seed, seconds,
                            trace, CPU)


def test_cells_found_by_name(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], tiny_root)
        assert cell.chips == w["chips"]
        assert harness.load_entry(cell.traffic["entry"], tiny_root)
        for kind in ("end_to_end", "per_layer"):
            for m in cell.metrics[kind]:
                assert callable(harness.load_reader(m["name"], tiny_root))
    with pytest.raises(KeyError):
        harness.load_cell("no.such.cell", tiny_root)


@pytest.mark.parametrize("name", ["dmel_140.fused", "dmel_140.cli"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_cpu(tiny_root, name, trace, capsys):
    r = _run(tiny_root, name, trace)
    harness.emit(r)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["checks"]) == set(harness.LIMITS)
    last = err.strip().splitlines()[-len(harness.LIMITS):]
    assert all(s.startswith("[bench] check ") and " limit " in s for s in last)
    cell = harness.load_cell(name, tiny_root)
    kind = "per_layer" if trace else "end_to_end"
    assert set(line["metrics"]) <= {m["name"] for m in cell.metrics[kind]}
    if not trace:
        rate = "job_mbps" if name.endswith(".cli") else "build_mbps"
        assert {rate, "setup_s", "host_peak_rss_gb"} <= set(line["metrics"])
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_per_layer_metrics_read_the_program(tiny_root):
    got = _run(tiny_root, "dmel_140.fused", trace=True)["metrics"]
    assert {"special.host_s", "fused.graph_s", "fused.finish_s",
            "result.pack_s"} <= set(got)
    got = _run(tiny_root, "dmel_140.cli", trace=True)["metrics"]
    assert {"cli.ingest_s", "cli.write_s"} <= set(got)


def _tree(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_alone(tiny_root):
    """A configuration, a traffic mix, an entry kind and a per-layer
    metric, each a new file, and new BENCHMARK.json entries: the files
    already there are not edited."""
    before = _tree(tiny_root)
    b = tiny_root / "benchmark"
    (b / "configs" / "pair_30k.json").write_text(json.dumps({
        "name": "pair_30k", "source": "a throwaway pair", "reduced": {},
        "collection": {"model": "uniform", "mbp": 0.03, "genomes": 2,
                       "mutation_rate": 0.01}}))
    (b / "traffic" / "twice_m24.json").write_text(json.dumps({
        "entry": "twice", "m": 24, "checked_share": 1.0, "env": {}}))
    (b / "entries" / "twice.py").write_text(
        "from benchmark.harness import _load_file\n"
        "import pathlib\n"
        "lib = _load_file(pathlib.Path(__file__).parent / 'library.py')\n"
        "class Entry(lib.Entry):\n"
        "    def build(self):\n"
        "        super().build()\n"
        "        return super().build()\n")
    (b / "metrics" / "twice.builds.py").write_text(
        "def read(w):\n    return float(len(w.builds))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "pair_30k", "source": "a throwaway pair",
                             "file": "benchmark/configs/pair_30k.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "pair_30k.twice", "config": "pair_30k",
                               "traffic": "twice_m24", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "twice.builds", "unit": "builds",
                               "better": "higher", "source": "program_counter",
                               "layer": "harness", "moves": "build_mbps",
                               "workloads": ["pair_30k.twice"]})
    bench["end_to_end"][0]["workloads"].append("pair_30k.twice")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _tree(tiny_root)
    assert {k: after[k] for k in before} == before

    r = _run(tiny_root, "pair_30k.twice")
    assert r["correct"] and "build_mbps" in r["metrics"]
    assert r["_notes"]["checked_builds"] == list(range(1, r["attempted"] + 1))
    r = _run(tiny_root, "pair_30k.twice", trace=True)
    assert r["correct"] and r["metrics"]["twice.builds"]["value"] >= 1
