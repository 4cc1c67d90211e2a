"""The readers of the program's own spans (measure/program.py) on
hand-made traces, the spans read from a real torch.profiler run on the
CPU, and the new per-layer metrics read from a tiny traced run."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import harness
from benchmark.measure import program, trace


def _window(t, n_builds=2):
    return types.SimpleNamespace(trace=t, builds=[{}] * n_builds)


def _trace():
    """Two builds. Device busy [1, 2), [4.5, 5), [7, 8)."""
    t = trace.Trace(
        window_s=10.0,
        device=[("k", 1.0, 2.0), ("k", 4.5, 5.0), ("k", 7.0, 8.0)],
        spans=[("bench.build", 0.0, 6.0)],
        host_ops=[],
    )
    t.program = [
            ("debwt.build", 0.0, 4.0),
            ("debwt.fused", 0.5, 4.0),
            ("debwt.graph", 0.5, 3.0),
            ("debwt.graph.inputs", 0.5, 1.5),
            ("debwt.graph.wait", 2.5, 3.0),
            ("debwt.finish", 3.0, 4.0),
            ("debwt.finish.wait", 3.5, 4.0),
            ("debwt.pack", 4.0, 6.0),
            ("debwt.pack.wait", 4.0, 4.5),
            ("debwt.pack.assemble", 4.5, 6.0),
            ("debwt.build", 6.0, 9.0),
            ("debwt.graph.inputs", 6.5, 7.5),
            ("debwt.graph.wait", 8.0, 8.5),
    ]
    return t


def test_stage_means():
    w = _window(_trace())
    assert program.stage_seconds(w, "debwt.graph.inputs") == 1.0
    assert program.stage_seconds(w, "debwt.pack.assemble") == 0.75
    assert program.stage_seconds(w, "debwt.nothing") is None


def test_wait_count_and_seconds():
    w = _window(_trace())
    assert program.waits(w, ["debwt.build"]) == (1.5, 0.75)
    assert program.waits(w, ["debwt.build", "debwt.pack"]) == (2.0, 1.0)
    assert program.waits(w, ["debwt.cli"]) is None


def test_idle_attribution_with_nested_spans():
    """Idle: [0, 1) over build's own time then inputs; [2, 4.5) across
    graph's own time, its wait, finish's own time, its wait and the
    pack's fetch; [5, 7) across assemble, the second build's own time
    and its inputs; [8, 10) across the wait, build's own time and no
    span (the harness)."""
    t = _trace()
    by = program.idle_by_span(t, t.program)
    want = {"debwt.build": 0.5 + 0.5 + 0.5, "debwt.graph.inputs": 1.0,
            "debwt.graph": 0.5, "debwt.graph.wait": 0.5 + 0.5,
            "debwt.finish": 0.5, "debwt.finish.wait": 0.5,
            "debwt.pack.wait": 0.5, "debwt.pack.assemble": 1.0,
            None: 1.0}
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert by[k] == pytest.approx(v), k
    assert sum(by.values()) == pytest.approx(10.0 - 2.5)
    # 1.5 s in build's own time and 1.0 s outside the program
    w = _window(_trace())
    assert program.idle_traced_pct(w) == pytest.approx(100 * 5.0 / 7.5)


def test_innermost_cuts_the_window():
    spans = [("a", 1.0, 5.0), ("b", 2.0, 3.0), ("c", 3.0, 4.0)]
    assert program.innermost(spans, 6.0) == [
        (0.0, 1.0, None), (1.0, 2.0, "a"), (2.0, 3.0, "b"),
        (3.0, 4.0, "c"), (4.0, 5.0, "a"), (5.0, 6.0, None)]


def test_no_program_spans_read_nothing():
    t = _trace()
    t.program = []
    w = _window(t)
    assert program.stage_seconds(w, "debwt.graph.inputs") is None
    assert program.waits(w, ["debwt.build"]) is None
    assert program.idle_traced_pct(w) is None
    assert program.idle_traced_pct(_window(None)) is None
    # a Trace of its own, with no profile in any calling frame
    bare = trace.Trace(window_s=1.0, device=[("k", 0.0, 0.5)], spans=[],
                       host_ops=[])
    assert program.spans(_window(bare)) == []
    assert program.idle_traced_pct(_window(bare)) is None


def test_spans_read_from_the_profile():
    """reduce still fills spans and host_ops as before; spans(w) finds
    the profile in a calling frame (here this test's) and keeps the
    program's host events on the Trace."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            with torch.profiler.record_function("bench.build"):
                with torch.profiler.record_function("debwt.build"):
                    with torch.profiler.record_function("debwt.graph"):
                        torch.arange(1000).sort()
    t = trace.reduce(prof)
    assert [s[0] for s in t.spans] == ["bench.build"]
    w = _window(t, n_builds=1)
    got = program.spans(w)
    assert got is t.program
    assert sorted(n for n, _, _ in got) == ["debwt.build", "debwt.graph"]
    (b, b0, b1), = [p for p in got if p[0] == "debwt.build"]
    (g, g0, g1), = [p for p in got if p[0] == "debwt.graph"]
    assert 0 <= b0 <= g0 < g1 <= b1 <= t.window_s
    assert program.stage_seconds(w, "debwt.graph") == pytest.approx(g1 - g0)
    assert program.reduce(prof) == got
    # host_ops keeps every host event that is not the harness's own
    names = [n for _, n in t.host_ops]
    assert "debwt.build" in names and "debwt.graph" in names
    assert any(n.startswith("aten::") for n in names)
    assert not any(n.startswith("bench.") for n in names)


CPU = torch.device("cpu")


def test_new_metrics_read_the_program(tiny_root):
    """On the CPU the device trace is empty, so the idle shares read
    nothing; the span metrics read the program."""
    def run(name):
        return harness.run_cell(harness.load_cell(name, tiny_root),
                                2**31 + 5, 0.3, True, CPU)["metrics"]

    got = run("dmel_140.fused")
    assert {"fused.inputs_s", "fused.wait_s", "fused.syncs",
            "result.fetch_s", "result.assemble_s"} <= set(got)
    # a tiny fused build waits 4 + rank_rounds times, and packed() once
    assert got["fused.syncs"]["value"] >= 5
    assert "device.idle_traced_pct.build" not in got
    got = run("dmel_140.cli")
    assert {"cli.read_s", "cli.parse_s", "cli.encode_s"} <= set(got)
    assert "device.idle_traced_pct.cli" not in got
