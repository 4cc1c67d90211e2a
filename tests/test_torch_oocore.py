"""The port's out-of-core tier on the CPU (device="cpu", toy sizes)
against the JAX package's: end to end on the configurations of
tests/test_oocore.py (the sharded-rank one excepted: that belongs to
the multi-device tier), checkpoint/resume, the route from api.build,
and stage by stage (chunk keys, splitters, the binner, the bucket
classification). All data is integer: every comparison is exact."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debwt_tpu import oocore as joocore
from debwt_tpu.io import native as jnative
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import api, grouped, ops, oocore
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.grouped import GroupedConfig
from debwt_tpu_torch.io import native
from debwt_tpu_torch.kernels import _build
from debwt_tpu_torch.oocore import OocConfig, build_bwt_ooc
from debwt_tpu_torch.pipeline import build_bwt
from debwt_tpu_torch.special import build_special
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

from conftest import random_reads

JAX_STATS = ("bucket_cap", "chunk", "n_chunks", "sp_len", "n_blue",
             "sharded_rank")


def _rng():
    return np.random.default_rng(0)


def _random(n, lo, hi):
    return lambda: random_reads(_rng(), n, lo=lo, hi=hi)


def _skew():
    # heavy duplicate key mass: one repeated motif dominates
    rng = _rng()
    motif = "ACGTACGTAAATTTCCCGGG" * 4
    return [motif * 3 + "".join(rng.choice(list("ACGT"), size=40))
            for _ in range(6)]


def _hot_31mer():
    # ~20% of the text is ONE repeated 31-mer: a node group larger than
    # any bucket cap, unsplittable by any number of buckets
    rng = _rng()
    motif = "".join(rng.choice(list("ACGT"), size=31))
    parts = []
    for _ in range(40):
        parts.append(motif)
        parts.append("".join(rng.choice(list("ACGT"), size=124)))
    return ["".join(parts),
            "".join(parts[:20]) + "".join(rng.choice(list("ACGT"), size=50))]


def _multi_out_single_in():
    # a giant run that is multi-out but single-in (case 2 at scale)
    rng = _rng()
    motif = "".join(rng.choice(list("ACGT"), size=32))
    parts = []
    for i in range(50):
        parts.append("C" + motif + "ACGT"[i % 4])
        parts.append("".join(rng.choice(list("ACGT"), size=37)))
    return ["".join(parts)]


# name -> (reads, m, OocConfig fields): tests/test_oocore.py's
CONFIGS = {
    "chunked_m12": (_random(12, 40, 200), 12, dict(chunk=256, n_buckets=8)),
    "chunked_m20": (_random(12, 40, 200), 20, dict(chunk=256, n_buckets=8)),
    "chunked_m32": (_random(12, 40, 200), 32, dict(chunk=256, n_buckets=8)),
    "vs_fused_m24": (_random(8, 60, 300), 24, dict(chunk=512, n_buckets=4)),
    "spill": (_random(6, 40, 150), 16, dict(chunk=128, n_buckets=8)),
    "repetitive_skew": (_skew, 14, dict(chunk=200, n_buckets=8)),
    "oversized_cap512": (_hot_31mer, 32,
                         dict(chunk=512, n_buckets=4, bucket_cap=512)),
    "oversized_cap32": (_hot_31mer, 32,
                        dict(chunk=512, n_buckets=2, bucket_cap=32)),
    "giant_run_cap24": (_multi_out_single_in, 32,
                        dict(chunk=512, n_buckets=2, bucket_cap=24)),
}


def _jax_coll(coll):
    return JaxCollection(x2=coll.x2, sep=coll.sep)


def _same_result(got, want):
    np.testing.assert_array_equal(got.bwt6, want.bwt6)
    np.testing.assert_array_equal(got.sharp_pos, want.sharp_pos)
    assert got.dollar_pos == want.dollar_pos
    assert got.packed() == want.packed()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ooc_matches_jax_ooc(name, tmp_path, monkeypatch):
    """Same reads, same knobs: the bytes, the sidecars and the plan's
    counts equal the JAX tier's, and golden's. Pass B takes each device
    classification's keys from one gathered call (_row_keys)."""
    make, m, fields = CONFIGS[name]
    coll = SequenceCollection.from_reads(make())
    spill = fields | (dict(spill_dir=str(tmp_path / "sp")) if name == "spill" else {})
    stats, jstats = {}, {}
    row_keys = _counting(monkeypatch, "_row_keys")
    got = build_bwt_ooc(coll, PipelineConfig(m=m), OocConfig(**spill),
                        stats=stats, device="cpu")
    jspill = fields | (dict(spill_dir=str(tmp_path / "jsp")) if name == "spill" else {})
    want = joocore.build_bwt_ooc(_jax_coll(coll), JaxConfig(m=m),
                                 joocore.OocConfig(**jspill), stats=jstats)
    _same_result(got, want)
    _same_result(got, golden_bwt(coll))
    assert {k: stats[k] for k in JAX_STATS} == {k: jstats[k] for k in JAX_STATS}
    assert stats["n_chunks"] > 1 and stats["bucket_cap"] < coll.bwt_len
    assert stats["n_buckets"] == fields["n_buckets"]
    assert set(stats["stage_s"]) == {
        "special module (host)", "text pack (host)", "pass A (keys + binning)",
        "pass B (bucket sorts)", "SP rank", "blue fill"}
    # wrappers count launches on a card only
    assert stats["launches"] == {"window_keys": 0, "window_keys_at": 0,
                                 "seg_scan_or": 0}
    cap = fields.get("bucket_cap")
    if cap is not None:
        assert stats["max_bucket_rows"] > cap and stats["oversized_buckets"] >= 1
        # and the oversized buckets' own keys, cap rows a call
        assert row_keys["n"] > stats["classifications"]
    else:
        assert stats["oversized_buckets"] == 0
        assert stats["classifications"] == (
            fields["n_buckets"] - _empty_buckets(coll, m, fields))
        assert row_keys["n"] == stats["classifications"]


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("name", ["oversized_cap512", "oversized_cap32",
                                  "giant_run_cap24"])
def test_ooc_oversized_spilled_matches_jax(name, checkpoint, tmp_path):
    """The oversized fallback (host key sort of device keys, slabs,
    single-key giant runs) on rows read back from 6-byte spill files:
    the JAX tier's bytes, spilled likewise, and golden's."""
    make, m, fields = CONFIGS[name]
    coll = SequenceCollection.from_reads(make())
    stats = {}
    got = build_bwt_ooc(coll, PipelineConfig(m=m), OocConfig(
        **fields, spill_dir=str(tmp_path / "sp"), checkpoint=checkpoint),
        stats=stats, device="cpu")
    want = joocore.build_bwt_ooc(_jax_coll(coll), JaxConfig(m=m), joocore.OocConfig(
        **fields, spill_dir=str(tmp_path / "jsp"), checkpoint=checkpoint))
    _same_result(got, want)
    _same_result(got, golden_bwt(coll))
    assert stats["oversized_buckets"] >= 1
    assert os.listdir(tmp_path / "sp") == []


def _empty_buckets(coll, m, fields):
    """Buckets with no row: no device classification for them."""
    k = m - 1
    split_c = min(16, k)
    spl = oocore.sample_splitters(coll.x2, fields["n_buckets"], split_c)
    x2p = np.concatenate([coll.x2, np.full(32, 3, np.uint8)])
    keys = ops.window_keys(torch.from_numpy(x2p[: coll.bwt_len + k - 1]), k).numpy()
    *_, counts = oocore._bin_rows_numpy(keys, 0, coll.sep, x2p, coll.bwt_len,
                                        spl, split_c, k)
    sp = build_special(coll, m)
    counts = counts + np.bincount(np.searchsorted(
        spl, (sp.spec_tfill >> np.uint64(2 * (k - split_c))).astype(np.uint32),
        side="right"), minlength=fields["n_buckets"])
    return int((counts == 0).sum())


def test_ooc_matches_the_fused_engine():
    make, m, fields = CONFIGS["vs_fused_m24"]
    coll = SequenceCollection.from_reads(make())
    got = build_bwt_ooc(coll, PipelineConfig(m=m), OocConfig(**fields),
                        device="cpu")
    _same_result(got, build_bwt(coll, PipelineConfig(m=m), device="cpu"))


def test_ooc_spill_files_gone_afterwards(tmp_path):
    """No file outlives a spilled build, bwt6.u8 included: the output
    pages to a mapping of a file unlinked as soon as it is mapped, and
    the result stays readable."""
    make, m, fields = CONFIGS["spill"]
    coll = SequenceCollection.from_reads(make())
    d = tmp_path / "sp"
    res = build_bwt_ooc(coll, PipelineConfig(m=m),
                        OocConfig(**fields, spill_dir=str(d)), device="cpu")
    assert os.listdir(d) == []
    # the output pages to the (unlinked) spill file, not to RSS
    assert isinstance(res.bwt6, np.memmap)
    _same_result(res, golden_bwt(coll))


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("name,n_buckets", [("spill", 8), ("repetitive_skew", 64)])
def test_ooc_spill_dir_empty_after_build(tmp_path, name, n_buckets, checkpoint):
    """A finished spilled build empties its spill directory: with
    checkpoints no bwt6.u8, SP or blue file and no manifest either. At
    64 buckets the skewed text leaves buckets empty, whose never-loaded
    files go too."""
    make, m, fields = CONFIGS[name]
    coll = SequenceCollection.from_reads(make())
    fields = dict(fields, n_buckets=n_buckets)
    d = tmp_path / "sp"
    res = build_bwt_ooc(coll, PipelineConfig(m=m),
                        OocConfig(**fields, spill_dir=str(d), checkpoint=checkpoint),
                        device="cpu")
    assert os.listdir(d) == []
    assert isinstance(res.bwt6, np.memmap)
    _same_result(res, golden_bwt(coll))
    assert (_empty_buckets(coll, m, fields) > 0) == (n_buckets == 64)


def test_ooc_sharded_rank_raises():
    """Past sp_cap the JAX package ranks over a device mesh: that is the
    multi-device tier, and the port says so."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 6, lo=60, hi=150))
    with pytest.raises(NotImplementedError, match="multi-device"):
        build_bwt_ooc(coll, PipelineConfig(m=14),
                      OocConfig(chunk=256, n_buckets=4, sp_cap=1), device="cpu")


def test_ooc_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coll = SequenceCollection.from_reads(random_reads(_rng(), 2, lo=40, hi=60))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bwt_ooc(coll, PipelineConfig(m=32), OocConfig(chunk=256))


# ---- checkpoint / resume ----

def _counting(monkeypatch, name, crash_at=None):
    """Wrap oocore.<name>: count calls, raise on call `crash_at`."""
    real = getattr(oocore, name)
    calls = {"n": 0}

    def wrapped(*a, **k):
        calls["n"] += 1
        if calls["n"] == crash_at:
            raise RuntimeError("simulated crash")
        return real(*a, **k)

    monkeypatch.setattr(oocore, name, wrapped)
    return calls


def test_checkpoint_resume_after_pass_a(tmp_path, monkeypatch):
    """Interrupted at the first classification: the resume skips pass A
    (no chunk keys) and gives the same bytes."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 8, lo=50, hi=180))
    ooc = OocConfig(chunk=256, n_buckets=8, spill_dir=str(tmp_path / "ck"),
                    checkpoint=True)
    _counting(monkeypatch, "_classify_bucket", crash_at=1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        build_bwt_ooc(coll, PipelineConfig(m=20), ooc, device="cpu")
    monkeypatch.undo()
    keys = _counting(monkeypatch, "_chunk_keys")
    res = build_bwt_ooc(coll, PipelineConfig(m=20), ooc, device="cpu")
    assert keys["n"] == 0, "pass A re-ran despite the checkpoint"
    _same_result(res, golden_bwt(coll))
    assert list((tmp_path / "ck").glob("bk*")) == []


def test_checkpoint_resume_mid_pass_b(tmp_path, monkeypatch):
    """Interrupted at the 4th classification: the resume continues at
    that bucket, without redoing the three done."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 10, lo=50, hi=180))
    ooc = OocConfig(chunk=256, n_buckets=8, spill_dir=str(tmp_path / "ck"),
                    checkpoint=True)
    _counting(monkeypatch, "_classify_bucket", crash_at=4)
    with pytest.raises(RuntimeError, match="simulated crash"):
        build_bwt_ooc(coll, PipelineConfig(m=16), ooc, device="cpu")
    monkeypatch.undo()
    classify = _counting(monkeypatch, "_classify_bucket")
    keys = _counting(monkeypatch, "_chunk_keys")
    stats = {}
    res = build_bwt_ooc(coll, PipelineConfig(m=16), ooc, stats=stats, device="cpu")
    assert 1 <= classify["n"] <= 8 - 3 + 1 and keys["n"] == 0
    assert stats["classifications"] == classify["n"]
    assert "pass A (resume attach)" in stats["stage_s"]
    _same_result(res, golden_bwt(coll))
    want = joocore.build_bwt_ooc(_jax_coll(coll), JaxConfig(m=16),
                                 joocore.OocConfig(chunk=256, n_buckets=8))
    _same_result(res, want)


def test_checkpoint_resume_leaves_no_bucket_files(tmp_path, monkeypatch):
    """Killed after bucket 3's manifest bump and before its files were
    deleted (delete() raises on its 4th call): the resume starts at
    bucket 4 and still removes bucket 3's files, so the directory is
    empty at the end, with golden's and the JAX tier's bytes."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 10, lo=50, hi=180))
    d = tmp_path / "ck"
    ooc = OocConfig(chunk=256, n_buckets=8, spill_dir=str(d), checkpoint=True)
    real, calls = oocore._BucketStore.delete, {"n": 0}

    def delete(self, b):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("simulated kill")
        return real(self, b)

    monkeypatch.setattr(oocore._BucketStore, "delete", delete)
    with pytest.raises(RuntimeError, match="simulated kill"):
        build_bwt_ooc(coll, PipelineConfig(m=16), ooc, device="cpu")
    monkeypatch.undo()
    with open(d / "manifest.json") as f:
        assert '"next_bucket": 4' in f.read()
    assert sorted(p.name for p in d.glob("bk3.*")) == ["bk3.k16", "bk3.off"]
    stats = {}
    res = build_bwt_ooc(coll, PipelineConfig(m=16), ooc, stats=stats, device="cpu")
    assert "pass A (resume attach)" in stats["stage_s"]
    assert os.listdir(d) == []
    _same_result(res, golden_bwt(coll))
    _same_result(res, joocore.build_bwt_ooc(
        _jax_coll(coll), JaxConfig(m=16), joocore.OocConfig(chunk=256, n_buckets=8)))


def test_checkpoint_done_runs_fresh(tmp_path, monkeypatch):
    """A completed manifest does not poison the next run."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 5, lo=40, hi=120))
    ooc = OocConfig(chunk=128, n_buckets=4, spill_dir=str(tmp_path / "ck"),
                    checkpoint=True)
    a = build_bwt_ooc(coll, PipelineConfig(m=16), ooc, device="cpu")
    keys = _counting(monkeypatch, "_chunk_keys")
    b = build_bwt_ooc(coll, PipelineConfig(m=16), ooc, device="cpu")
    assert keys["n"] > 0
    _same_result(a, b)


def test_jax_manifest_is_not_resumed(tmp_path, monkeypatch):
    """The two packages lay out their spill files differently: a JAX
    manifest interrupted mid pass B is not resumed by the port, which
    builds afresh in the same directory."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 10, lo=50, hi=180))
    d = str(tmp_path / "ck")
    real = joocore._classify_bucket
    calls = {"n": 0}

    def crash_on_4th(*a, **k):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("simulated crash")
        return real(*a, **k)

    monkeypatch.setattr(joocore, "_classify_bucket", crash_on_4th)
    with pytest.raises(RuntimeError, match="simulated crash"):
        joocore.build_bwt_ooc(_jax_coll(coll), JaxConfig(m=16), joocore.OocConfig(
            chunk=256, n_buckets=8, spill_dir=d, checkpoint=True))
    monkeypatch.undo()
    with open(os.path.join(d, "manifest.json")) as f:
        assert '"stage": "B"' in f.read()
    fp_args = (coll, 16, 8, 256)
    assert oocore._fingerprint(*fp_args) != joocore._fingerprint(*fp_args)
    keys = _counting(monkeypatch, "_chunk_keys")
    res = build_bwt_ooc(coll, PipelineConfig(m=16), OocConfig(
        chunk=256, n_buckets=8, spill_dir=d, checkpoint=True), device="cpu")
    assert keys["n"] > 0
    _same_result(res, golden_bwt(coll))


def test_layout_1_manifest_is_not_resumed(tmp_path, monkeypatch):
    """A spill directory of the port's layout 1 (18-byte rows, no runs)
    interrupted mid pass B is not resumed: its fingerprint carries the
    old layout, so the build starts afresh and gives golden's bytes."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 10, lo=50, hi=180))
    ooc = OocConfig(chunk=256, n_buckets=8, spill_dir=str(tmp_path / "ck"),
                    checkpoint=True)
    monkeypatch.setattr(oocore, "_SPILL_LAYOUT", (1 << 32) | 1)
    _counting(monkeypatch, "_classify_bucket", crash_at=4)
    with pytest.raises(RuntimeError, match="simulated crash"):
        build_bwt_ooc(coll, PipelineConfig(m=16), ooc, device="cpu")
    monkeypatch.undo()
    st = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert st["stage"] == "B" and st["next_bucket"] == 3
    assert st["fingerprint"] != oocore._fingerprint(coll, 16, 8, 256)
    keys = _counting(monkeypatch, "_chunk_keys")
    res = build_bwt_ooc(coll, PipelineConfig(m=16), ooc, device="cpu")
    assert keys["n"] > 0
    _same_result(res, golden_bwt(coll))


def test_manifest_runs_rebuild_positions(tmp_path, monkeypatch):
    """After pass A the manifest holds runs[b, c], the rows of bucket b
    from chunk c, and no key: they equal the per-chunk counts of the
    plain binner, match the 4-byte offset files, and the resume mid pass
    B rebuilds the JAX tier's bytes from them."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 10, lo=50, hi=180))
    m, nb, C = 16, 8, 256
    d = tmp_path / "ck"
    ooc = OocConfig(chunk=C, n_buckets=nb, spill_dir=str(d), checkpoint=True)
    _counting(monkeypatch, "_classify_bucket", crash_at=1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        build_bwt_ooc(coll, PipelineConfig(m=m), ooc, device="cpu")
    monkeypatch.undo()
    st = json.loads((d / "manifest.json").read_text())
    assert st["stage"] == "A" and "sizes" not in st
    runs = np.asarray(st["runs"])
    N, k = coll.bwt_len, m - 1
    assert runs.shape == (nb, -(-N // C))
    x2p = np.concatenate([coll.x2, np.full(32, 3, np.uint8)])
    keys = ops.window_keys(torch.from_numpy(x2p[: N + k - 1]), k).numpy()
    spl = np.asarray(st["splitters"], dtype=np.uint32)
    for ci in range(runs.shape[1]):
        sl = slice(ci * C, min(N, (ci + 1) * C))
        *_, cnt = oocore._bin_rows_numpy(keys[sl], ci * C, coll.sep, x2p, N,
                                         spl, min(16, k), k)
        np.testing.assert_array_equal(runs[:, ci], cnt)
    for b in range(nb):
        assert (d / f"bk{b}.off").stat().st_size == 4 * runs[b].sum()
        assert (d / f"bk{b}.k16").stat().st_size == 2 * runs[b].sum()
    _counting(monkeypatch, "_classify_bucket", crash_at=3)
    with pytest.raises(RuntimeError, match="simulated crash"):
        build_bwt_ooc(coll, PipelineConfig(m=m), ooc, device="cpu")
    monkeypatch.undo()
    st = json.loads((d / "manifest.json").read_text())
    assert st["stage"] == "B" and np.array_equal(st["runs"], runs)
    res = build_bwt_ooc(coll, PipelineConfig(m=m), ooc, device="cpu")
    _same_result(res, joocore.build_bwt_ooc(
        _jax_coll(coll), JaxConfig(m=m), joocore.OocConfig(chunk=C, n_buckets=nb)))


# ---- the route from api.build ----

def test_api_routes_to_ooc_after_group_overflow(monkeypatch, capsys):
    """A single node key outgrows the group cap (the all-A read): the
    grouped tier overflows and api.build takes the out-of-core tier,
    which builds the JAX tier's bytes."""
    coll = SequenceCollection.from_reads(
        [np.zeros(3000, dtype=np.uint8), np.full(300, 2, np.uint8)])
    monkeypatch.setattr(api, "_SINGLE_ROWS", 64)
    stats = {}
    res = api.build(coll, PipelineConfig(m=32), device="cpu", verbose=True,
                    gcfg=GroupedConfig(cap=256), stats=stats)
    err = capsys.readouterr().err
    assert "grouped tier overflow" in err and "out-of-core chunked tier" in err
    assert stats["n_buckets"] == 64 and "n_groups" not in stats
    want = joocore.build_bwt_ooc(_jax_coll(coll), JaxConfig(m=32))
    _same_result(res, want)
    _same_result(res, golden_bwt(coll))


def test_api_routes_to_ooc_over_max_n(monkeypatch, capsys):
    coll = SequenceCollection.from_reads(random_reads(_rng(), 6, lo=40, hi=120))
    monkeypatch.setattr(api, "_SINGLE_ROWS", 64)
    monkeypatch.setattr(grouped, "MAX_N", coll.bwt_len)
    stats = {}
    res = api.build(coll, PipelineConfig(m=20), device="cpu", verbose=True,
                    stats=stats)
    err = capsys.readouterr().err
    assert "out-of-core chunked tier" in err and "grouped" not in err
    assert stats["n_chunks"] == 1 and stats["chunk"] >= coll.bwt_len
    want = joocore.build_bwt_ooc(_jax_coll(coll), JaxConfig(m=20))
    _same_result(res, want)


# ---- stage by stage ----

@pytest.mark.parametrize("m,C,seed", [(12, 256, 0), (32, 1024, 1), (20, 16, 2)])
def test_chunk_keys_match_jax(m, C, seed):
    """Kernel 1 at w = k = m - 1 on a chunk's freshly packed words."""
    k = m - 1
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 4, size=C + k).astype(np.uint8)
    buf[-k // 2:] = 3                      # a T halo, as past the text
    words = ops.pack_2bit_words_host(buf)
    got = oocore._chunk_keys(torch.from_numpy(words.view(np.int32)), k, C)
    assert got.dtype == torch.int64 and got.shape == (C,)
    assert int(got.min()) >= 0 and int(got.max()) < 1 << (2 * k)
    hi, lo = joocore._chunk_keys(jnp.asarray(words), k, C)
    np.testing.assert_array_equal(
        got.numpy(), ops.keys_from_pair(np.asarray(hi), np.asarray(lo)))


@pytest.mark.parametrize("m", [12, 20, 32])
def test_row_keys_match_jax_chunk_keys(m):
    """Pass B's keys from the packed text at a bucket's positions (chunk
    runs, ascending, across chunk bases that are not multiples of 16)
    equal the keys JAX's pass A computes for those positions."""
    k = m - 1
    coll = SequenceCollection.from_reads(random_reads(np.random.default_rng(m),
                                                      12, lo=60, hi=300))
    N = coll.bwt_len
    x2p = np.concatenate([coll.x2, np.full(32, 3, np.uint8)])
    C = 200
    n_chunks = -(-N // C)
    words = ops.pack_text(x2p, -(-(n_chunks * C + k) // 16), "cpu")
    rng = np.random.default_rng(m + 1)
    pos = np.sort(rng.choice(N, size=N // 5, replace=False)).astype(np.int64)
    pos[-1] = N - 1                        # the last position: a T halo
    got = oocore._row_keys(words, pos, k).numpy()
    want = np.empty(N, np.int64)
    for ci in range(n_chunks):
        c0 = ci * C
        buf = np.full(C + k, 3, np.uint8)
        take = min(C + k, x2p.shape[0] - c0)
        buf[:take] = x2p[c0 : c0 + take]
        hi, lo = joocore._chunk_keys(jnp.asarray(ops.pack_2bit_words_host(buf)), k, C)
        want[c0 : min(N, c0 + C)] = ops.keys_from_pair(
            np.asarray(hi), np.asarray(lo))[: min(C, N - c0)]
    np.testing.assert_array_equal(got, want[pos])


@pytest.mark.parametrize("n,c", [(8, 16), (64, 11), (2, 16), (4, 5)])
def test_sample_splitters_match_jax(n, c):
    x2 = np.random.default_rng(n + c).integers(0, 4, size=7000).astype(np.uint8)
    got = oocore.sample_splitters(x2, n, c)
    np.testing.assert_array_equal(got, joocore.sample_splitters(x2, n, c))
    assert got.dtype == np.uint32 and got.shape == (n - 1,)


def _pass_a_inputs(seed, m, nb):
    coll = SequenceCollection.from_reads(random_reads(np.random.default_rng(seed),
                                                      20, lo=35, hi=400))
    k = m - 1
    N = coll.bwt_len
    x2p = np.concatenate([coll.x2, np.full(32, 3, np.uint8)])
    keys = ops.window_keys(torch.from_numpy(x2p[: N + k - 1]), k).numpy()
    split_c = min(16, k)
    spl = oocore.sample_splitters(coll.x2, nb, split_c)
    return coll, keys, x2p, spl, split_c, k


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("m,nb", [(12, 8), (32, 64), (20, 3)])
def test_native_binner_matches_numpy(threads, m, nb):
    """The native binner fills every bucket with the same rows in the
    same order (ascending position) as its plain version, chunk by
    chunk, for every thread count; and as the JAX package's binner."""
    coll, keys, x2p, spl, split_c, k = _pass_a_inputs(m + nb, m, nb)
    N = coll.bwt_len
    sep = coll.sep.astype(np.int64)
    C = 256
    for c0 in range(0, N, C):
        key = np.ascontiguousarray(keys[c0 : min(c0 + C, N)])
        got = native.ooc_bin(key, c0, sep, x2p, N, spl, split_c, k, threads=threads)
        want = oocore._bin_rows_numpy(key, c0, sep, x2p, N, spl, split_c, k)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        starts = np.concatenate([[0], np.cumsum(got[3])])
        for b in range(nb):
            assert (np.diff(got[2][starts[b] : starts[b + 1]]) > 0).all()
        if jnative.has_ooc_bin():
            hi, lo = ops.pair_from_keys(key)
            j = jnative.ooc_bin(hi, lo, c0, sep, x2p, N, spl, split_c, k)
            tot = int(j[4].sum())
            np.testing.assert_array_equal(
                got[0], ops.keys_from_pair(j[0][:tot], j[1][:tot]))
            np.testing.assert_array_equal(got[1], j[2][:tot])
            np.testing.assert_array_equal(got[2], j[3][:tot])
            np.testing.assert_array_equal(got[3], j[4])


def test_native_binner_checks_its_arrays():
    coll, keys, x2p, spl, split_c, k = _pass_a_inputs(3, 16, 4)
    N, sep = coll.bwt_len, coll.sep.astype(np.int64)
    with pytest.raises(ValueError, match="int64"):
        native.ooc_bin(keys[:64].astype(np.int32), 0, sep, x2p, N, spl, split_c, k)
    with pytest.raises(ValueError, match="uint32"):
        native.ooc_bin(keys[:64], 0, sep, x2p, N, spl.astype(np.int64), split_c, k)
    with pytest.raises(ValueError, match="out of range"):
        native.ooc_bin(keys[:64], N - 10, sep, x2p, N, spl, split_c, k)


def test_native_binner_that_fails_to_build_raises(monkeypatch, tmp_path):
    """No quiet turn to the NumPy binner: a failed build is an error,
    and the build raises with it."""
    coll = SequenceCollection.from_reads(random_reads(_rng(), 4, lo=40, hi=90))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "CXX_FLAGS", ("-std=c++17", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="build failed for ooc_binner"):
        build_bwt_ooc(coll, PipelineConfig(m=20), OocConfig(chunk=128),
                      device="cpu")


def _jax_classify(key, k16, ord_, cap):
    """JAX's _classify_bucket on the same rows, padded to its cap."""
    n = key.shape[0]
    hi, lo = ops.pair_from_keys(key)
    pad = lambda a, v, dt: np.concatenate(  # noqa: E731
        [a.astype(dt), np.full(cap - n, v, dt)])
    return joocore._classify_bucket(
        jnp.asarray(pad(hi, 0xFFFFFFFF, np.uint32)),
        jnp.asarray(pad(lo, 0xFFFFFFFF, np.uint32)),
        jnp.asarray(pad(k16, 2 << 12, np.int32)),
        jnp.asarray(np.concatenate([ord_, np.arange(n, cap, dtype=np.int32)])),
        cap,
    )


@pytest.mark.parametrize("m,nb", [(12, 4), (32, 8), (17, 2)])
def test_classify_bucket_matches_jax(m, nb):
    """Each bucket of one pass A, with its special rows: the port's
    classification equals the first `total` rows of JAX's, row by row
    (a sort on fewer than all three keys would show here)."""
    rng = np.random.default_rng(m)
    frags = ["".join(rng.choice(list("ACGT"), size=45)) for _ in range(4)]
    reads = ["".join(rng.choice(frags) for _ in range(4)) for _ in range(14)]
    coll = SequenceCollection.from_reads(reads)
    k = m - 1
    N = coll.bwt_len
    x2p = np.concatenate([coll.x2, np.full(32, 3, np.uint8)])
    keys = ops.window_keys(torch.from_numpy(x2p[: N + k - 1]), k).numpy()
    split_c = min(16, k)
    spl = oocore.sample_splitters(coll.x2, nb, split_c)
    r_key, r_k16, r_pos, counts = oocore._bin_rows_numpy(
        keys, 0, coll.sep, x2p, N, spl, split_c, k)
    sp = build_special(coll, m)
    s_dest = np.searchsorted(
        spl, (sp.spec_tfill >> np.uint64(2 * (k - split_c))).astype(np.uint32),
        side="right")
    s_ord = ((np.arange(s_dest.shape[0]) << 3) | sp.spec_bwt6).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    seen_multi = 0
    for b in range(nb):
        sl = slice(starts[b], starts[b + 1])
        s_idx = np.nonzero(s_dest == b)[0]
        key = np.concatenate([r_key[sl], sp.spec_tfill[s_idx].view(np.int64)])
        k16 = np.concatenate([r_k16[sl].astype(np.int32),
                              np.full(s_idx.shape[0], 1 << 12, np.int32)])
        ord_ = np.concatenate([np.arange(counts[b], dtype=np.int32), s_ord[s_idx]])
        # rows in a shuffled input order: the sort must decide everything
        perm = rng.permutation(key.shape[0])
        key, k16, ord_ = key[perm], k16[perm], ord_[perm]
        got = oocore._classify_bucket(*(torch.from_numpy(a) for a in (key, k16, ord_)))
        cap = max(16, 1 << (key.shape[0] - 1).bit_length())
        want = _jax_classify(key, k16, ord_, cap)
        total = int(want[6])
        assert got[6] == total == key.shape[0]
        for a, w in zip(got[:6], want[:6]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w)[:total])
        assert got[3].dtype == got[4].dtype == torch.int32
        seen_multi += int(got[1].sum()) + int(got[2].sum())
    assert seen_multi > 0


def _store_rows(rng, store, n_chunks, chunk, c_first=0):
    """Rows appended to every bucket of `store` chunk by chunk (a bucket
    may get none from a chunk), as pass A appends them; returns
    {bucket: [(k16, pos) of each append]}."""
    want = {b: [] for b in range(store.n)}
    for ci in range(c_first, c_first + n_chunks):
        for b in range(store.n):
            n = int(rng.integers(0, 20))
            pos = np.sort(rng.choice(chunk, n, replace=False)).astype(np.int64)
            cols = (rng.integers(0, 1 << 12, n).astype(np.uint16),
                    pos + np.int64(ci) * chunk)
            store.append(b, ci, *cols)
            want[b].append(cols)
    store.close()
    return want


@pytest.mark.parametrize("spill", [False, True])
def test_bucket_store_round_trip(tmp_path, spill):
    """Rows come back per bucket in the order appended, from DRAM lists
    or from spill files of 6 bytes a row (read into staging buffers,
    deleted as consumed, or kept for delete() under checkpointing); the
    positions come back from the offsets and the runs."""
    rng = np.random.default_rng(9)
    d = str(tmp_path / "st") if spill else None
    store = oocore._BucketStore(3, 4, 64, d)
    want = _store_rows(rng, store, 4, 64)
    staging = ({c: np.empty(100, dt) for c, dt in
                oocore._BucketStore.COLS + (("pos", np.int64),)}
               if spill else None)
    for b in range(3):
        got = store.load(b, consume=b != 1, staging=staging)
        assert got[0].dtype == np.uint16 and got[1].dtype == np.int64
        for i in range(2):
            np.testing.assert_array_equal(
                got[i], np.concatenate([w[i] for w in want[b]]))
        assert list(store.runs[b]) == [w[1].shape[0] for w in want[b]]
    assert list(store.sizes) == [sum(len(w[1]) for w in want[b]) for b in range(3)]
    if spill:
        left = sorted(p.name for p in (tmp_path / "st").iterdir())
        assert left == ["bk1.k16", "bk1.off"]
        assert (tmp_path / "st" / "bk1.off").stat().st_size == 4 * store.sizes[1]
        store.delete(1)
        assert list((tmp_path / "st").iterdir()) == []


@pytest.mark.parametrize("spill", [False, True])
def test_bucket_store_positions_past_2_32(tmp_path, spill):
    """Chunks of the default 2^26 positions whose bases lie past 2^32
    (chunks 63 to 66: base 63 * 2^26 = 4,227,858,432 is under 2^32, the
    next three over it): each position comes back exactly as int64 from
    its uint32 offset, also after a resume that attaches to the files
    and takes the runs from the manifest."""
    rng = np.random.default_rng(3)
    C = 1 << 26
    d = str(tmp_path / "st") if spill else None
    store = oocore._BucketStore(2, 67, C, d)
    want = _store_rows(rng, store, 4, C, c_first=63)
    if spill:
        runs = np.asarray(json.loads(json.dumps(store.runs.tolist())))
        store = oocore._BucketStore(2, 67, C, d, reopen=True)
        store.runs = runs
    seen = []
    for b in range(2):
        k16, pos = store.load(b)
        np.testing.assert_array_equal(pos, np.concatenate([w[1] for w in want[b]]))
        np.testing.assert_array_equal(k16, np.concatenate([w[0] for w in want[b]]))
        seen.append(pos)
    seen = np.concatenate(seen)
    assert seen.min() < 1 << 32 <= seen.max()
    assert not store.runs[:, :63].any()


def test_bucket_store_refuses_rows_out_of_order():
    """A run of rows per chunk, chunks in order, positions inside the
    chunk: anything else could not be rebuilt from the runs."""
    store = oocore._BucketStore(1, 3, 64, None)
    store.append(0, 1, np.zeros(2, np.uint16), np.array([64, 70]))
    with pytest.raises(AssertionError):
        store.append(0, 0, np.zeros(1, np.uint16), np.array([5]))
    with pytest.raises(AssertionError):
        store.append(0, 2, np.zeros(1, np.uint16), np.array([200]))
