"""The port's one recorder (tracing.py) on the CPU: the span tree of a
fused build, of packed() and of a CLI job under torch.profiler, the
timings labels, the counters against the spans and against the grouped
tier's counts, and that tracing changes neither the bytes nor the
device syncs; on near-identical genomes, the fused finishing stage's
three parts and its rank rounds."""

import numpy as np
import pytest
import torch

from debwt_tpu_torch import api, tracing
from debwt_tpu_torch.cli import main as torch_main
from debwt_tpu_torch.golden import golden_bwt
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


# (span, the span it lies in): directly, but where DIRECT names others
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
    ("debwt.finish.sp", "debwt.finish"),
    ("debwt.finish.rank", "debwt.finish"),
    ("debwt.finish.blue", "debwt.finish"),
    ("debwt.finish.enqueue", "debwt.finish"),
    ("debwt.finish.wait", "debwt.finish"),
    ("debwt.pack", None),
    ("debwt.pack.wait", "debwt.pack"),
    ("debwt.pack.assemble", "debwt.pack"),
]
# the finishing stage's launches and waits sit in its three parts: the
# SP sort's wait for its length, a rank round's, and the sidecars' in
# debwt.finish itself
DIRECT = {
    "debwt.finish.enqueue": {"debwt.finish.sp", "debwt.finish.rank",
                             "debwt.finish.blue"},
    "debwt.finish.wait": {"debwt.finish.sp", "debwt.finish.rank",
                          "debwt.finish"},
}


def _ancestors(e) -> set:
    """The names of every debwt. span around e."""
    out, p = set(), e.cpu_parent
    while p is not None:
        if p.name.startswith("debwt."):
            out.add(p.name)
        p = p.cpu_parent
    return out


@pytest.mark.parametrize("name,parent", FUSED_TREE)
def test_fused_build_span_tree(fused_traced, name, parent):
    """Each span of the fused route sits inside its parent, and only
    there: directly, or through the parts DIRECT names."""
    events = fused_traced[3]
    tree = _tree(events)
    assert {p for n, p in tree if n == name} == DIRECT.get(name, {parent})
    assert parent is None or all(
        parent in _ancestors(e) for e in events if e.name == name)


def test_fused_build_opens_no_other_span(fused_traced):
    assert _tree(fused_traced[3]) == {
        (n, q) for n, p in FUSED_TREE for q in DIRECT.get(n, {p})}


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


def _genomes(seed, n=20, length=2000, rate=0.005):
    """n copies of one random genome, each but the first with its own
    point substitutions at `rate`: an SP string with long repeats."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=length).astype(np.uint8)
    genomes = [base]
    for _ in range(n - 1):
        g = base.copy()
        idx = rng.choice(length, size=int(length * rate), replace=False)
        g[idx] = (g[idx] + rng.integers(1, 4, size=idx.shape[0])) % 4
        genomes.append(g)
    return SequenceCollection.from_concat(
        np.concatenate(genomes), np.full(n, length, dtype=np.int64))


@pytest.fixture(scope="module", params=[0, 1, 2])
def genomes_traced(request):
    coll = _genomes(request.param)

    def run():
        r = api.build(coll, PipelineConfig(m=32), device=CPU)
        return r, r.packed()

    (r, packed), events = _profiled(run)
    return coll, r, packed, events


def test_genome_collection_is_golden(genomes_traced):
    coll, r, packed, _ = genomes_traced
    g = golden_bwt(coll)
    assert packed == g.packed()
    np.testing.assert_array_equal(r.sharp_pos, g.sharp_pos)
    assert r.dollar_pos == g.dollar_pos


FINISH_PARTS = ["debwt.finish.sp", "debwt.finish.rank", "debwt.finish.blue"]


def test_finish_parts_tile_in_order(genomes_traced):
    """debwt.finish.sp, .rank and .blue sit in debwt.finish, once each,
    in that order and apart."""
    parts = sorted((e for e in genomes_traced[3] if e.name in FINISH_PARTS),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in parts] == FINISH_PARTS
    assert {_parent(e) for e in parts} == {"debwt.finish"}
    for a, b in zip(parts, parts[1:]):
        assert a.time_range.end <= b.time_range.start


def test_rank_rounds_are_the_waits_in_rank(genomes_traced):
    """One wait a rank round, all inside debwt.finish.rank, and more
    than one round on near-identical genomes; the SP sort waits once,
    the blue fill never."""
    _, r, _, events = genomes_traced
    waits = [e for e in events if e.name.endswith(".wait")]
    inside = {p: sum(p in _ancestors(e) for e in waits)
              for p in FINISH_PARTS}
    assert inside["debwt.finish.rank"] == r.counters["rank_rounds"] > 1
    assert inside["debwt.finish.sp"] == 1
    assert inside["debwt.finish.blue"] == 0


def test_finish_spans_add_no_sync(genomes_traced):
    """graph L/B, L_dyn, a wait a rank round, the sidecars, the pack
    fetch, each a wait span: the three parts add no sync."""
    _, r, _, events = genomes_traced
    c = r.counters
    assert c["syncs"] == 4 + c["rank_rounds"]
    assert c["syncs"] == sum(e.name.endswith(".wait") for e in events)


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
