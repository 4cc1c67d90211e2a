"""The port's one recorder (tracing.py) on the CPU: the span tree of a
fused build, of packed() and of a CLI job under torch.profiler, the
timings labels, the counters against the spans and against the grouped
tier's counts, and that tracing changes neither the bytes nor the
device syncs."""

import numpy as np
import pytest
import torch

from debwt_tpu_torch import api, tracing
from debwt_tpu_torch.cli import main as torch_main
from debwt_tpu_torch.grouped import GroupedConfig, build_bwt_grouped
from debwt_tpu_torch.oocore import OocConfig, build_bwt_ooc
from debwt_tpu_torch.pipeline import build_bwt, stage_inputs
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

CPU = torch.device("cpu")


def _coll(seed=0, n=6):
    """Reads that share a core of 120 bases, so that nodes branch into
    and out of it."""
    rng = np.random.default_rng(seed)
    core = "".join(rng.choice(list("ACGT"), size=120))
    reads = []
    for _ in range(n):
        a = "".join(rng.choice(list("ACGT"), size=int(rng.integers(10, 60))))
        b = "".join(rng.choice(list("ACGT"), size=int(rng.integers(10, 60))))
        reads.append(a + core + b)
    return SequenceCollection.from_reads(reads)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("debwt.")]


def _parent(e):
    """The innermost debwt. span around e, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("debwt."):
        p = p.cpu_parent
    return None if p is None else p.name


def _tree(events) -> set:
    return {(e.name, _parent(e)) for e in events}


@pytest.fixture(scope="module")
def fused_traced():
    coll = _coll()

    def run():
        r = api.build(coll, PipelineConfig(m=32), device=CPU)
        return r, r.packed()

    (r, packed), events = _profiled(run)
    return coll, r, packed, events


FUSED_TREE = [
    ("debwt.build", None),
    ("debwt.route", "debwt.build"),
    ("debwt.fused", "debwt.build"),
    ("debwt.special", "debwt.fused"),
    ("debwt.graph", "debwt.fused"),
    ("debwt.graph.inputs", "debwt.graph"),
    ("debwt.graph.h2d", "debwt.graph"),
    ("debwt.graph.enqueue", "debwt.graph"),
    ("debwt.graph.wait", "debwt.graph"),
    ("debwt.finish", "debwt.fused"),
    ("debwt.finish.enqueue", "debwt.finish"),
    ("debwt.finish.wait", "debwt.finish"),
    ("debwt.pack", None),
    ("debwt.pack.wait", "debwt.pack"),
    ("debwt.pack.assemble", "debwt.pack"),
]


@pytest.mark.parametrize("name,parent", FUSED_TREE)
def test_fused_build_span_tree(fused_traced, name, parent):
    """Each span of the fused route sits inside its parent, and only
    there."""
    tree = _tree(fused_traced[3])
    assert (name, parent) in tree
    assert {p for n, p in tree if n == name} == {parent}


def test_fused_build_opens_no_other_span(fused_traced):
    assert _tree(fused_traced[3]) == set(FUSED_TREE)


def test_timings_labels_and_counters(fused_traced):
    coll, r, _, events = fused_traced
    assert {"special module (host)", "stage_graph (+h2d, sync)",
            "stage_finish (+sync)", "packed"} <= set(r.timings)
    assert all(v >= 0 for v in r.timings.values())
    c = r.counters
    waits = [e for e in events if e.name.endswith(".wait")]
    assert c["syncs"] == len(waits)
    # graph L/B, L_dyn, the sidecars, the pack fetch
    assert c["syncs"] == 4 + c["rank_rounds"] and c["rank_rounds"] >= 1
    assert c["rows"] >= coll.bwt_len
    # the text's codes, once, and the four small padded arrays
    inp = stage_inputs(coll, 32)
    assert c["h2d_bytes"] == coll.bwt_len + sum(
        a.nbytes for a in (inp.sep_pos, inp.spec_key, inp.spec_char6,
                           inp.spec_branch))
    n_words = -(-coll.bwt_len // 16)
    # the packed words and the '#' rows
    assert c["d2h_bytes"] >= n_words * 4 + 8 * (coll.n_reads - 1)
    assert c["sp_events"] > 0 and c["blue_entries"] > 0


def test_graph_children_cover_the_graph(fused_traced):
    """inputs + h2d + enqueue + wait tile debwt.graph: no other span
    sits there, and they never overlap."""
    ev = fused_traced[3]
    graph = [e for e in ev if e.name == "debwt.graph"][0]
    kids = sorted((e for e in ev if _parent(e) == "debwt.graph"),
                  key=lambda e: e.time_range.start)
    assert [e.name.split(".")[-1] for e in kids] == [
        "inputs", "h2d", "enqueue", "wait"]
    for a, b in zip(kids, kids[1:]):
        assert a.time_range.end <= b.time_range.start
    assert graph.time_range.start <= kids[0].time_range.start
    assert kids[-1].time_range.end <= graph.time_range.end


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_match_the_grouped_tier(seed):
    coll = _coll(seed, n=5 + seed)
    cfg = PipelineConfig(m=32)
    fused = build_bwt(coll, cfg, device=CPU)
    stats = {}
    grouped = build_bwt_grouped(coll, cfg, GroupedConfig(cap=256),
                                stats=stats, device=CPU)
    assert stats["n_groups"] >= 2
    assert fused.counters["sp_events"] == stats["sp_len"]
    assert fused.counters["blue_entries"] == stats["n_blue"]
    assert grouped.counters["sp_events"] == stats["sp_len"]
    assert grouped.counters["blue_entries"] == stats["n_blue"]
    ostats = {}
    ooc = build_bwt_ooc(coll, cfg, OocConfig(chunk=256, n_buckets=8),
                        stats=ostats, device=CPU)
    assert ooc.counters["sp_events"] == ostats["sp_len"] == stats["sp_len"]
    assert ooc.counters["blue_entries"] == stats["n_blue"]
    # the tiers' marks keep their labels
    assert {"special module (host)", "text pack (host)",
            "group passes (device)", "groups.select", "SP rank",
            "blue fill"} <= set(grouped.timings)
    assert grouped.packed() == fused.packed() == ooc.packed()


GROUPED_TREE = [
    ("debwt.build", None),
    ("debwt.route", "debwt.build"),
    ("debwt.grouped", "debwt.build"),
    ("debwt.grouped.special", "debwt.grouped"),
    ("debwt.grouped.text", "debwt.grouped"),
    ("debwt.grouped.groups", "debwt.grouped"),
    ("debwt.grouped.select", "debwt.grouped.groups"),
    ("debwt.grouped.select.wait", "debwt.grouped.select"),
    ("debwt.grouped.classify", "debwt.grouped.groups"),
    ("debwt.grouped.rows", "debwt.grouped.groups"),
    ("debwt.grouped.rows.wait", "debwt.grouped.rows"),
    ("debwt.grouped.sp", "debwt.grouped"),
    ("debwt.rank.enqueue", "debwt.grouped.sp"),
    ("debwt.rank.wait", "debwt.grouped.sp"),
    ("debwt.grouped.fill", "debwt.grouped"),
    ("debwt.finish.wait", "debwt.grouped.fill"),
    ("debwt.grouped.stats.wait", "debwt.grouped"),
    ("debwt.pack", None),
    ("debwt.pack.wait", "debwt.pack"),
    ("debwt.pack.assemble", "debwt.pack"),
]


@pytest.fixture(scope="module")
def grouped_traced():
    coll = _coll(6, n=7)
    stats = {}

    def run():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(api, "_SINGLE_ROWS", 64)

            def no_mark(*a, **k):
                raise AssertionError("tracing.mark on the grouped path")

            syncs = []
            mp.setattr(tracing, "mark", no_mark)
            mp.setattr(torch.cuda, "synchronize",
                       lambda *a, **k: syncs.append(a))
            r = api.build(coll, PipelineConfig(m=32, check=True), device=CPU,
                          gcfg=GroupedConfig(cap=256), stats=stats)
            return r, r.packed(), syncs

    (r, packed, syncs), events = _profiled(run)
    return coll, r, packed, syncs, stats, events


def test_grouped_build_span_tree(grouped_traced):
    """The grouped route opens its stages as spans, each inside its
    parent and only there, and no other span."""
    *_, stats, events = grouped_traced
    assert stats["n_groups"] >= 2
    assert _tree(events) == set(GROUPED_TREE)


def test_grouped_path_waits_only_in_wait(grouped_traced):
    """No tracing.mark, no torch.cuda.synchronize; each blocking fetch
    is a wait span, counted once; the tier's labels and counters."""
    coll, r, packed, syncs, stats, events = grouped_traced
    assert syncs == []
    waits = [e for e in events if e.name.endswith(".wait")]
    assert r.counters["syncs"] == len(waits) > 0
    G = stats["n_groups"]
    # a chunk's count a group, a group's rows, the sidecars and the
    # count check, the rank rounds, the stats hook, the pack's fetch
    assert r.counters["syncs"] == (G * stats["n_chunks"] + G + 2
                                   + r.counters["rank_rounds"] + 1 + 1)
    assert r.counters["groups"] == G and r.counters["group_attempts"] == 1
    assert r.counters["sp_events"] == stats["sp_len"] > 0
    assert r.counters["blue_entries"] == stats["n_blue"] > 0
    assert r.counters["h2d_bytes"] >= coll.bwt_len
    assert r.counters["d2h_bytes"] >= 4 * -(-coll.bwt_len // 16)
    assert {"special module (host)", "text pack (host)",
            "group passes (device)", "groups.select", "groups.classify",
            "groups.fetch", "SP rank", "blue fill",
            "sidecars + pack (device)", "packed"} == set(r.timings)
    assert set(stats["stage_s"]) == set(r.timings) - {"packed"}
    assert packed == build_bwt(coll, PipelineConfig(m=32), device=CPU).packed()


def test_bytes_unchanged_by_the_profiler(fused_traced):
    coll, r, packed, _ = fused_traced
    plain = api.build(coll, PipelineConfig(m=32), device=CPU)
    assert plain.packed() == packed
    np.testing.assert_array_equal(plain.sharp_pos, r.sharp_pos)
    assert plain.dollar_pos == r.dollar_pos
    assert plain.counters == r.counters


def test_fused_path_never_synchronizes(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    r = api.build(_coll(3), PipelineConfig(m=32), device=CPU)
    r.packed()
    assert calls == [] and r.counters["syncs"] > 0


def test_the_check_fetch_is_a_wait():
    r = build_bwt(_coll(2), PipelineConfig(m=32, check=True), device=CPU)
    # graph L/B, L_dyn, the sidecars, the counts
    assert r.counters["syncs"] == 4 + r.counters["rank_rounds"]


def _fasta(path, coll):
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = np.concatenate([[0], coll.sep[:-1] + 1])
    with open(path, "w") as f:
        for i, (s, e) in enumerate(zip(starts, coll.sep)):
            seq = acgt[coll.x2[s:e]].tobytes().decode()
            f.write(f">r{i}\n")
            for j in range(0, len(seq), 60):
                f.write(seq[j : j + 60] + "\n")


CLI_TREE = [
    ("debwt.cli", None),
    ("debwt.ingest", "debwt.cli"),
    ("debwt.ingest.read", "debwt.ingest"),
    ("debwt.ingest.parse", "debwt.ingest"),
    ("debwt.ingest.encode", "debwt.ingest"),
    ("debwt.ingest.join", "debwt.ingest"),
    ("debwt.build", "debwt.cli"),
    ("debwt.write", "debwt.cli"),
    ("debwt.pack", "debwt.write"),
]


@pytest.fixture(scope="module")
def cli_traced(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    _fasta(d / "in.fa", _coll(4))
    argv = [str(d / "in.fa"), "-o", str(d / "o.bwt"), "--device", "cpu",
            "--timings"]
    return _profiled(lambda: torch_main(argv))


@pytest.mark.parametrize("name,parent", CLI_TREE)
def test_cli_span_tree(cli_traced, name, parent):
    rc, events = cli_traced
    assert rc == 0
    assert {p for n, p in _tree(events) if n == name} == {parent}


def test_cli_timings_print_stages_and_counters(tmp_path, capsys):
    _fasta(tmp_path / "in.fa", _coll(5))
    assert torch_main([str(tmp_path / "in.fa"), "-o", str(tmp_path / "o.bwt"),
                       "--device", "cpu", "--timings"]) == 0
    err = capsys.readouterr().err
    lines = err.splitlines()
    i_wrote = next(i for i, ln in enumerate(lines) if "] wrote " in ln)
    shown = {ln.split()[1] for ln in lines[i_wrote + 1:]}
    assert {"ingest", "stage_graph", "build", "packed", "write", "sp_events",
            "blue_entries", "rows", "h2d_bytes", "d2h_bytes",
            "syncs"} <= shown
    assert "s ingest)" in err and "Mbp/s" in err


def test_recordings_nest_and_marks_add():
    with tracing.recording() as outer:
        with tracing.span("x", "x"):
            pass
        with tracing.recording() as inner:
            tracing.count("n", 2)
            tracing.mark("m")
            tracing.mark("m")
        assert tracing.current() is outer
    assert tracing.current() is None
    assert set(outer.timings) == {"x", "m"} and set(inner.timings) == {"m"}
    assert outer.counters == inner.counters == {"n": 2}
    # with no recording open a span and a count keep nothing and work
    with tracing.span("y", "y"):
        tracing.count("n")
    got = tracing.wait("z", lambda: torch.zeros(3, dtype=torch.int32))
    assert got.shape == (3,)
