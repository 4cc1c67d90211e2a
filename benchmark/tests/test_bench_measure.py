"""The yardstick on hand-made inputs: the kernels' bytes, the rows the
input needs, the union of device activity, the idle gaps, and the means."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark.measure import readers, roofline, trace
from debwt_tpu_torch.pipeline import rows_needed


def test_kernel_bytes():
    assert roofline.window_keys_bytes(1000, 32) == (1000 + 31) / 4 + 8000
    assert roofline.seg_or_bytes(1 << 20) == 8 << 20
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("N,n,m", [(100, 1, 32), (140_000_004, 4, 32),
                                   (1_000_000_004, 4, 32), (5_000, 300, 24),
                                   (167_772_161, 9, 12)])
def test_seg_or_rows_are_the_inputs(N, n, m):
    """A row a text position and m - 1 a read: never more than the
    program's padded rows, so padding cut away cannot lower the share."""
    coll = types.SimpleNamespace(bwt_len=N, n_reads=n)
    assert roofline.seg_or_rows(N, n, m) == N + n * (m - 1)
    assert roofline.seg_or_rows(N, n, m) <= rows_needed(coll, m)


def _trace():
    return trace.Trace(
        window_s=10.0,
        device=[("k1", 1.0, 3.0), ("k1", 2.0, 4.0), ("memcpy", 6.0, 7.0)],
        spans=[("bench.build", 0.0, 5.2), ("bench.pack", 5.2, 10.0)],
        host_ops=[(0.5, "aten::sort"), (4.5, "aten::copy_")],
    )


def test_busy_union_and_idle_gaps():
    t = _trace()
    assert t.busy_intervals() == [[1.0, 4.0], [6.0, 7.0]]
    assert t.busy_s() == 4.0
    assert t.kernel_seconds(["k1"]) == 4.0
    assert t.kernel_seconds(["nothing"]) is None
    assert t.device_ops() == [["k1", 4.0], ["memcpy", 1.0]]
    assert t.idle_gaps() == [["pack after aten::copy_", 3.0],
                             ["build after aten::sort", 2.0],
                             ["build after start", 1.0]]
    w = types.SimpleNamespace(trace=t, builds=[{}, {}])
    assert readers.idle_pct(w) == pytest.approx(60.0)
    # two builds' bytes at the card's bandwidth over 4 s of kernel time
    assert readers.share_of_bound(w, ["k1"], 3.35e12) == pytest.approx(50.0)
    assert readers.share_of_bound(w, ["k2"], 3.35e12) is None


def test_device_activity_is_clipped_to_the_window():
    t = trace.Trace(window_s=2.0, device=[("k", -1.0, 0.5), ("k", 1.5, 3.0)],
                    spans=[], host_ops=[])
    assert t.busy_s() == 1.0


def test_means_over_builds():
    w = types.SimpleNamespace(builds=[
        {"timings": {"a": 1.0, "b": 2.0}, "spans": {"ingest": 0.5}},
        {"timings": {"a": 3.0, "b": 4.0}, "spans": {}},
        {"timings": {"a": 5.0}, "spans": {"ingest": 1.5}},
    ])
    assert readers.mean_seconds(w, ["a"]) == 3.0
    assert readers.mean_seconds(w, ["a", "b"]) == 5.0
    assert readers.mean_seconds(w, ["ingest"], where="spans") == 1.0
    assert readers.mean_seconds(w, ["c"]) is None


def test_reduce_finds_the_window_and_the_spans():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            with torch.profiler.record_function("bench.build"):
                torch.arange(1000).sort()
    t = trace.reduce(prof)
    assert t.window_s > 0 and t.device == []
    assert [s[0] for s in t.spans] == ["bench.build"]
    assert any(name.startswith("aten::") for _, name in t.host_ops)
