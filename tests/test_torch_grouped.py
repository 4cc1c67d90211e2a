"""The port's grouped device-resident tier on the CPU (device="cpu",
toy sizes) against the JAX package's: end to end on the configurations
of tests/test_grouped.py, stage by stage through the conversion helpers
of debwt_tpu_torch.grouped, and the back half it borrows from the
out-of-core tier. All data is integer: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debwt_tpu import bluesort as jbluesort
from debwt_tpu import grouped as jgrouped
from debwt_tpu import oocore as joocore
from debwt_tpu.pipeline import _bucket as jax_bucket
from debwt_tpu.pipeline import _pow2 as jax_pow2
from debwt_tpu.special import build_special as jax_build_special
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import api, bluesort, grouped, ops
from debwt_tpu_torch import oocore
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.grouped import (
    GroupedConfig, GroupOverflow, build_bwt_grouped,
)
from debwt_tpu_torch.model import build_model
from debwt_tpu_torch.pipeline import build_bwt
from debwt_tpu_torch.synth import synth_concat_codes
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

STATS = ("n_groups", "n_chunks", "ns_cap", "sp_len", "n_blue")


def _rand_reads(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.choice(4, size=int(rng.integers(lo, hi))).astype(np.uint8)
            for _ in range(n)]


def _branch_dense(seed):
    # near-identical copies with mutations: multi-in/multi-out density
    rng = np.random.default_rng(seed)
    base = rng.choice(4, size=4000).astype(np.uint8)
    reads = []
    for g in range(4):
        gen = base.copy()
        if g:
            idx = rng.choice(len(gen), size=40, replace=False)
            gen[idx] = (gen[idx] + rng.integers(1, 4, size=40)) % 4
        reads.append(gen)
    return reads


def _skewed(seed):
    # one dominant repeated 40-mer: hot key prefixes stress the
    # splitter plan and the overflow retry
    rng = np.random.default_rng(seed)
    motif = rng.choice(4, size=40).astype(np.uint8)
    parts = []
    for _ in range(60):
        parts.append(motif)
        parts.append(rng.choice(4, size=int(rng.integers(5, 30))).astype(np.uint8))
    read = np.concatenate(parts)
    return [read, read[:500]]


def _top_bit(seed):
    # T runs at the start of the text and of reads: at m = 32 their
    # window keys have the top bit set and cross the splitters
    rng = np.random.default_rng(seed)
    t = np.full(70, 3, np.uint8)
    r = lambda n: rng.choice(4, size=n).astype(np.uint8)  # noqa: E731
    return [np.concatenate([t, r(200), t[:45], r(150)]),
            np.concatenate([t[:40], r(300)]),
            np.concatenate([r(120), t, t]),
            np.concatenate([np.full(33, 3, np.uint8), np.full(60, 2, np.uint8), r(90)])]


CONFIGS = {
    "multigroup": (lambda: _rand_reads(0, 12, 40, 200), 32, 512, 256),
    "single_group": (lambda: _rand_reads(1, 4, 40, 90), 32, 100_000, 1 << 12),
    "m12": (lambda: _rand_reads(2, 8, 34, 120), 12, 1024, 512),
    "m20": (lambda: _rand_reads(2, 8, 34, 120), 20, 1024, 512),
    "m32": (lambda: _rand_reads(2, 8, 34, 120), 32, 1024, 512),
    "branch_dense": (lambda: _branch_dense(3), 24, 4096, 2048),
    "skewed": (lambda: _skewed(4), 32, 2048, 1024),
    "top_bit_m32": (lambda: _top_bit(5), 32, 512, 256),
}


def _jax_coll(coll):
    return JaxCollection(x2=coll.x2, sep=coll.sep)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grouped_matches_jax_grouped(name):
    """Same reads, same plan: BWT, sidecars, packed bytes and the plan's
    counts equal the JAX tier's, and the fused engine's."""
    make, m, cap, chunk = CONFIGS[name]
    coll = SequenceCollection.from_reads(make())
    stats, jstats = {}, {}
    got = build_bwt_grouped(
        coll, PipelineConfig(m=m, check=True), GroupedConfig(cap=cap, chunk=chunk),
        stats=stats, device="cpu",
    )
    want = jgrouped.build_bwt_grouped(
        _jax_coll(coll), JaxConfig(m=m, check=True),
        jgrouped.GroupedConfig(cap=cap, chunk=chunk), stats=jstats,
    )
    np.testing.assert_array_equal(got.bwt6, want.bwt6)
    np.testing.assert_array_equal(got.sharp_pos, want.sharp_pos)
    assert got.dollar_pos == want.dollar_pos
    assert got.packed() == want.packed()
    assert {k: stats[k] for k in STATS} == {k: jstats[k] for k in STATS}
    assert stats["attempts"] == 1
    assert stats["groups_selected"] == stats["groups_classified"] == stats["n_groups"]
    fused = build_bwt(coll, PipelineConfig(m=m), device="cpu")
    assert got.packed() == fused.packed()
    if name == "multigroup":
        assert stats["n_groups"] >= 2 and stats["n_chunks"] >= 2
    if name == "single_group":
        assert stats["n_groups"] == 1
    if name == "top_bit_m32":
        # keys with the top bit set lie on both sides of the last
        # splitter: it is a node key (the key >> 2) whose top bit is set,
        # and the all-T key of the text's first window lies above it
        _, splitters = grouped._plan_groups(coll, m - 1, cap, 0)
        assert stats["n_groups"] >= 3 and (coll.x2[:32] == 3).all()
        assert (1 << 61) <= int(splitters[-1]) < (1 << 62) - 1


@pytest.mark.parametrize("name", ["multigroup", "branch_dense"])
def test_trace_tells_sp_length_and_blue_count(name, monkeypatch, capsys):
    """Under DEBWT_TRACE=1 the tier prints its SP length and blue count
    in the out-of-core tier's words (what a CLI run is held to): both
    equal the stats and the JAX grouped tier's on the same input."""
    make, m, cap, chunk = CONFIGS[name]
    coll = SequenceCollection.from_reads(make())
    monkeypatch.setenv("DEBWT_TRACE", "1")
    capsys.readouterr()
    stats, jstats = {}, {}
    build_bwt_grouped(coll, PipelineConfig(m=m), GroupedConfig(cap=cap, chunk=chunk),
                      stats=stats, device="cpu")
    lines = capsys.readouterr().err.splitlines()
    jgrouped.build_bwt_grouped(
        _jax_coll(coll), JaxConfig(m=m), jgrouped.GroupedConfig(cap=cap, chunk=chunk),
        stats=jstats)
    assert stats["sp_len"] == jstats["sp_len"] > 0
    assert stats["n_blue"] == jstats["n_blue"] > 0
    said = [ln for ln in lines if ln.startswith("[debwt-torch grouped] SP string")
            or ln.startswith("[debwt-torch grouped] blue entries")]
    assert said == [f"[debwt-torch grouped] SP string: {stats['sp_len']} events",
                    f"[debwt-torch grouped] blue entries: {stats['n_blue']}"]


def test_grouped_overflow_raises():
    # cap far below N/G with a single hot key: unsplittable
    coll = SequenceCollection.from_reads([np.zeros(3000, dtype=np.uint8)])
    with pytest.raises(GroupOverflow):
        build_bwt_grouped(coll, PipelineConfig(m=32),
                          GroupedConfig(cap=256, chunk=512), device="cpu")
    with pytest.raises(jgrouped.GroupOverflow):
        jgrouped.build_bwt_grouped(
            _jax_coll(coll), JaxConfig(m=32),
            jgrouped.GroupedConfig(cap=256, chunk=512),
        )


@pytest.mark.parametrize("hot,cap,attempts,cap_run", [
    (1700, 2048, 3, 2048), (3900, 4096, 3, 4096),
])
def test_grouped_retry_keeps_cap_run(hot, cap, attempts, cap_run):
    """A node key with more occurrences than the first plan's cap_run
    but fewer than cap: the JAX tier halves cap_run as G doubles and
    gives up; the port's retry keeps the rows of the group that
    overflowed (never more than cap) and builds the same bytes as the
    fused engine."""
    rng = np.random.default_rng(3)
    read = np.concatenate([np.zeros(hot + 31, np.uint8),
                           rng.choice(4, size=6000 - hot).astype(np.uint8)])
    coll = SequenceCollection.from_reads(
        [read, rng.choice(4, size=300).astype(np.uint8)])
    stats = {}
    got = build_bwt_grouped(
        coll, PipelineConfig(m=32, check=True),
        GroupedConfig(cap=cap, chunk=1024), stats=stats, device="cpu",
    )
    assert stats["attempts"] == attempts and stats["cap_run"] == cap_run
    assert stats["cap_run"] <= stats["cap"] == cap
    assert stats["groups_selected"] > stats["groups_classified"]
    want = build_bwt(coll, PipelineConfig(m=32), device="cpu")
    np.testing.assert_array_equal(got.bwt6, want.bwt6)
    assert got.packed() == want.packed()
    with pytest.raises(jgrouped.GroupOverflow):
        jgrouped.build_bwt_grouped(
            _jax_coll(coll), JaxConfig(m=32),
            jgrouped.GroupedConfig(cap=cap, chunk=1024),
        )


# ---- stage by stage ----

def _plan(coll, m, cap, chunk):
    """The operands of both packages' _select_group for one plan."""
    k = m - 1
    N = coll.bwt_len
    C = min(chunk, jax_pow2(max(1024, N)))
    C -= C % 16
    n_chunks = -(-N // C)
    E = C + m + 15
    E += (-E) % 16
    x2ext = np.full(16 + (n_chunks - 1) * C + E, 3, np.uint8)
    x2ext[16 : 16 + N] = coll.x2
    x2w = ops.pack_2bit_words_host(x2ext)
    G, splitters = jgrouped._plan_groups(_jax_coll(coll), k, cap, 0.85, 0)
    G2, splitters2 = grouped._plan_groups(coll, k, cap, 0)
    assert G == G2 and (splitters == splitters2).all()
    cap_run = min(cap, jax_bucket(int(N / G / 0.85)))
    cap_run += (-cap_run) % 4
    return dict(N=N, C=C, n_chunks=n_chunks, E=E, x2w=x2w, G=G,
                splitters=splitters, cap_run=cap_run)


def _jax_select(coll, p, g, m):
    lo = int(p["splitters"][g - 1]) if g else 0
    hi = int(p["splitters"][g]) if g < p["G"] - 1 else 0
    sep_d = jnp.asarray(np.pad(
        coll.sep.astype(np.uint32),
        (0, jax_pow2(coll.n_reads) - coll.n_reads),
        constant_values=np.uint32(0xFFFFFFFF),
    ))
    return jgrouped._select_group(
        jnp.asarray(p["x2w"]), sep_d, np.uint32(p["N"]),
        np.uint32(lo >> 32), np.uint32(lo & 0xFFFFFFFF),
        np.uint32(hi >> 32), np.uint32(hi & 0xFFFFFFFF),
        np.bool_(g == p["G"] - 1), m, p["C"], p["cap_run"], p["n_chunks"], p["E"],
    ), lo, hi


def _classify_group(*args):
    """The port's classification of one group with the counts on the
    host, as the JAX module's _classify_group returns them: (fill2,
    b_key, b_sgc, b_pos, n_g, E_g)."""
    fill2, rows, n_valid = grouped._classify_rows(*args)
    b_key, b_sgc, b_pos = grouped._event_rows(*rows)
    return fill2, b_key, b_sgc, b_pos, int(n_valid), b_key.shape[0]


def _sorted_rows(key, ord_, f8, n):
    order = np.argsort(ord_[:n], kind="stable")
    return key[:n][order], ord_[:n][order], f8[:n][order]


@pytest.mark.parametrize("name", ["multigroup", "m20", "top_bit_m32", "branch_dense"])
def test_select_and_classify_match_jax_stages(name):
    """Every group of one plan: the selected rows (as a set: key, ord,
    f8 and the count) and the classification's outputs equal the JAX
    stages', through select_from_jax / classify_from_jax and back."""
    make, m, cap, chunk = CONFIGS[name]
    coll = SequenceCollection.from_reads(make())
    p = _plan(coll, m, cap, chunk)
    sp = jax_build_special(_jax_coll(coll), m)
    n_spec = sp.spec_tfill.shape[0]
    spec_dest = (np.searchsorted(p["splitters"], sp.spec_tfill, side="right")
                 if p["G"] > 1 else np.zeros(n_spec, np.int64))
    ns_cap = jax_pow2(max(16, int(np.bincount(spec_dest, minlength=p["G"]).max())))
    s_hi = (sp.spec_tfill >> np.uint64(32)).astype(np.uint32)
    s_lo = (sp.spec_tfill & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    s_hi2 = (s_hi << np.uint32(2)) | (s_lo >> np.uint32(30))
    s_lo2 = (s_lo << np.uint32(2)) | np.uint32(3)
    s_ord = jgrouped.ORD_SPEC | np.arange(n_spec, dtype=np.uint32)
    x2w_t = torch.from_numpy(p["x2w"].view(np.int32))
    _sep_d, seps = grouped._chunk_seps(coll.sep.astype(np.int64), "cpu", p["C"],
                                       p["n_chunks"], m - 1)
    cap_run, R = p["cap_run"], p["cap_run"] + ns_cap
    for g in range(p["G"]):
        (jhi, jlo, jord, jf8, joff), lo, hi = _jax_select(coll, p, g, m)
        bkey, bord, bf8, n = grouped._select_group(
            x2w_t, seps, p["N"], lo, hi, g == p["G"] - 1,
            m, p["C"], cap_run, p["E"],
        )
        assert n == int(joff) <= cap_run
        jrows = grouped.select_from_jax(jhi, jlo, jord, jf8, cap_run)
        for a, b in zip(_sorted_rows(bkey.numpy(), bord.numpy(), bf8.numpy(), n),
                        _sorted_rows(*jrows, n)):
            np.testing.assert_array_equal(a, b)
        # pads, and the way back
        assert (bkey.numpy()[n:] == -1).all() and (bf8.numpy()[n:] == 0).all()
        back = grouped.select_to_jax(bkey.numpy(), bord.numpy(), bf8.numpy())
        assert (back[2][n:] == 0xFFFFFFFF).all() and back[2].dtype == np.uint32
        np.testing.assert_array_equal(np.sort(back[2][:n]),
                                      np.sort(np.asarray(jord)[:cap_run][:n]))

        def pad(a, fillv, smask=spec_dest == g):
            out = np.full(ns_cap, fillv, dtype=a.dtype)
            out[: int(smask.sum())] = a[smask]
            return out

        jspec = (pad(s_hi2, np.uint32(0xFFFFFFFF)), pad(s_lo2, np.uint32(0xFFFFFFFF)),
                 pad(s_ord, np.uint32(0xFFFFFFFF)), pad(sp.spec_bwt6, np.uint8(0)))
        jout = jgrouped._classify_group(
            jhi, jlo, jord, jf8, *(jnp.asarray(a) for a in jspec),
            m, cap_run, ns_cap,
        )
        want = grouped.classify_from_jax(*jout)
        s_key = ops.keys_from_pair(jspec[0], jspec[1])
        # the port's classification on the JAX rows (in the JAX order)
        # and on its own rows (in text order) gives the same outputs
        for rows in (jrows, (bkey.numpy(), bord.numpy(), bf8.numpy())):
            got = _classify_group(
                *(torch.from_numpy(np.array(a)) for a in rows),
                torch.from_numpy(s_key), torch.from_numpy(grouped.ord_from_jax(jspec[2])),
                torch.from_numpy(jspec[3]), m, cap_run, ns_cap,
            )
            got = tuple(a.numpy() if isinstance(a, torch.Tensor) else a for a in got)
            assert got[4:] == want[4:]
            for a, b in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(grouped.classify_to_jax(*got, R), jout):
                np.testing.assert_array_equal(a, np.asarray(b))


# a main row's position moved past 2^31 (and by 2^20 more, so that no
# shifted position sits on the boundary): its JAX uint32 ord rises to
# 0x80100000 and up, under ORD_SPEC; its port int32 ord turns positive
POS_SHIFT = (1 << 31) + (1 << 20)


def _shift_main(jord):
    jord = np.asarray(jord).copy()
    main = jord < jgrouped.ORD_SPEC
    jord[main] += np.uint32(POS_SHIFT)
    assert (jord[main] < jgrouped.ORD_SPEC).all()
    return jord


@pytest.mark.parametrize("name", ["multigroup", "top_bit_m32", "branch_dense"])
def test_classify_positions_past_2_31_match_jax(name):
    """Every group of one plan with every main row's position shifted
    past 2^31, as a text over 2.15 Gbp gives them: the port's
    classification equals the JAX module's (fills, keys, b_sgc, b_pos);
    the events and their flags are those of the unshifted rows, and
    b_pos is int64, the shifted position, at or over 2^31."""
    make, m, cap, chunk = CONFIGS[name]
    coll = SequenceCollection.from_reads(make())
    p = _plan(coll, m, cap, chunk)
    sp = jax_build_special(_jax_coll(coll), m)
    n_spec = sp.spec_tfill.shape[0]
    spec_dest = (np.searchsorted(p["splitters"], sp.spec_tfill, side="right")
                 if p["G"] > 1 else np.zeros(n_spec, np.int64))
    ns_cap = jax_pow2(max(16, int(np.bincount(spec_dest, minlength=p["G"]).max())))
    s_hi = (sp.spec_tfill >> np.uint64(32)).astype(np.uint32)
    s_lo = (sp.spec_tfill & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    s_hi2 = (s_hi << np.uint32(2)) | (s_lo >> np.uint32(30))
    s_lo2 = (s_lo << np.uint32(2)) | np.uint32(3)
    s_ord = jgrouped.ORD_SPEC | np.arange(n_spec, dtype=np.uint32)
    cap_run = p["cap_run"]
    shifted_events = 0
    for g in range(p["G"]):
        (jhi, jlo, jord, jf8, joff), _lo, _hi = _jax_select(coll, p, g, m)
        smask = spec_dest == g

        def pad(a, fillv):
            out = np.full(ns_cap, fillv, dtype=a.dtype)
            out[: int(smask.sum())] = a[smask]
            return out

        jspec = (pad(s_hi2, np.uint32(0xFFFFFFFF)), pad(s_lo2, np.uint32(0xFFFFFFFF)),
                 pad(s_ord, np.uint32(0xFFFFFFFF)), pad(sp.spec_bwt6, np.uint8(0)))
        s_key = torch.from_numpy(ops.keys_from_pair(jspec[0], jspec[1]))
        s_ordp = torch.from_numpy(grouped.ord_from_jax(jspec[2]))

        def both(jord_in):
            jout = jgrouped._classify_group(
                jhi, jlo, jnp.asarray(jord_in), jf8,
                *(jnp.asarray(a) for a in jspec), m, cap_run, ns_cap)
            rows = grouped.select_from_jax(jhi, jlo, jord_in, jf8, cap_run)
            got = _classify_group(
                *(torch.from_numpy(np.array(a)) for a in rows), s_key, s_ordp,
                torch.from_numpy(jspec[3]), m, cap_run, ns_cap)
            assert got[3].dtype == torch.int64
            got = tuple(a.numpy() if isinstance(a, torch.Tensor) else a for a in got)
            want = grouped.classify_from_jax(*jout)
            assert got[4:] == want[4:]
            for a, b in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(a, b)
            return got

        jord_s = _shift_main(jord)
        assert (jord_s[: int(joff)] >= 1 << 31).all()
        base, moved = both(np.asarray(jord)), both(jord_s)
        np.testing.assert_array_equal(moved[1], base[1])        # events, flags
        main_ev = base[3] < jgrouped.ORD_SPEC
        np.testing.assert_array_equal(moved[3][main_ev], base[3][main_ev] + POS_SHIFT)
        np.testing.assert_array_equal(moved[3][~main_ev], base[3][~main_ev])
        assert (moved[3] >= 1 << 31).all()
        shifted_events += int(main_ev.sum())
    assert shifted_events > 0


def test_ord_conversion_keeps_classes_and_order():
    u = np.array([0, 5, 0xDFFFFFFF, 0xE0000000, 0xE0000007, 0xEFFFFFFF,
                  0xF0000000, 0xFFFFFFFF], dtype=np.uint32)
    i = grouped.ord_from_jax(u)
    assert i.dtype == np.int32 and (np.diff(i.astype(np.int64)) > 0).all()
    assert i[0] == -grouped.ORD_BIAS and i[-1] == grouped.PAD_ORD
    assert (i[:3] < grouped.ORD_SPEC - grouped.ORD_BIAS).all()
    assert (i[3:6] >= grouped.ORD_SPEC - grouped.ORD_BIAS).all()
    assert (i[3:6] < grouped.ORD_PAD - grouped.ORD_BIAS).all()
    np.testing.assert_array_equal(grouped.ord_to_jax(i), u)
    assert grouped.MAX_N == jgrouped.MAX_N == int(jgrouped.ORD_SPEC)


@pytest.mark.parametrize("n,k", [(2, 11), (7, 31), (64, 19)])
def test_sample_splitters_match_jax(n, k):
    x2 = np.random.default_rng(n).choice(4, size=5000).astype(np.uint8)
    np.testing.assert_array_equal(
        grouped.sample_splitters64(x2, n, k, seed=18),
        jgrouped.sample_splitters64(x2, n, k, seed=18),
    )


# ---- the back half borrowed from the out-of-core tier ----

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blue_coordinates_match_jax(seed):
    rng = np.random.default_rng(seed)
    L, B = 300, 500
    sp_pos = np.sort(rng.choice(10**6, size=L, replace=False)).astype(np.int64)
    rank = rng.permutation(L).astype(np.int32)
    b_base = rng.choice(np.array([0, 7, 1 << 33, (1 << 33) + 40]), size=B)
    b_pos = rng.integers(0, sp_pos[-1], size=B).astype(np.int64)
    b_char = rng.integers(0, 6, size=B).astype(np.uint8)
    got = oocore.blue_coordinates(b_base, b_pos, b_char, rank, sp_pos, "cpu")
    want = joocore.blue_coordinates(b_base, b_pos, b_char, rank, sp_pos)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[0].max() > 1 << 33


@pytest.mark.parametrize("seed,L", [(0, 0), (1, 1), (2, 97), (3, 1000)])
def test_sp_ranks_host_match_jax(seed, L):
    rng = np.random.default_rng(seed)
    # a low-entropy string: long ties, several rank rounds
    sp6 = rng.choice(np.array([0, 0, 0, 1, 4], np.uint8), size=L)
    if L:
        sp6[-1] = 5
    got = oocore._sp_ranks_host(sp6, L, oocore.SP_CAP, "cpu", print)
    want = joocore._sp_ranks_host(sp6, L, joocore.OocConfig(), None, print)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if L > 1:    # and they are the suffix order
        order = sorted(range(L), key=lambda i: list(sp6[i:]))
        np.testing.assert_array_equal(np.argsort(got), order)


@pytest.mark.parametrize("M,L_dyn", [(64, None), (512, 400), (3000, 2900)])
def test_bluesort_sp_suffix_ranks_match_jax(M, L_dyn):
    rng = np.random.default_rng(M)
    sp6 = np.resize(rng.integers(0, 6, size=7).astype(np.uint8), M)
    sp6[rng.random(M) < 0.01] = 5
    live = M if L_dyn is None else L_dyn
    sp6[live:] = 0
    got = bluesort.sp_suffix_ranks(torch.from_numpy(sp6), L_dyn).numpy()
    want = np.asarray(jbluesort.sp_suffix_ranks(
        jnp.asarray(sp6), None if L_dyn is None else jnp.int32(L_dyn)))
    np.testing.assert_array_equal(got[:live], want[:live])


def test_sp_ranks_host_refuses_sharded_rank():
    with pytest.raises(NotImplementedError, match="multi-device"):
        oocore._sp_ranks_host(np.zeros(40, np.uint8), 40, 32, "cpu", print)


def test_sp_stream_matches_model():
    """The grouped tier's SP event stream (positions and branch chars,
    exposed by the stats hook) equals the NumPy model's, elementwise."""
    coll = SequenceCollection.from_reads(_branch_dense(9) + _rand_reads(9, 5, 40, 200))
    _, tr = build_model(coll, m=32, trace=True)
    stats = {}
    build_bwt_grouped(coll, PipelineConfig(m=32), GroupedConfig(cap=2048, chunk=1024),
                      stats=stats, device="cpu")
    assert stats["n_groups"] >= 2 and stats["sp_len"] == tr.sp_positions.shape[0] > 0
    np.testing.assert_array_equal(stats["sp_pos"], tr.sp_positions)
    np.testing.assert_array_equal(stats["sp6"], tr.sp6)


# ---- caps and routing ----

def test_cap_explicit_then_device(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    # an explicit cap decides the plan, whatever the device holds
    monkeypatch.setattr(api, "_device_memory_bytes", lambda dev: 1 / 0)
    coll = SequenceCollection.from_reads(_rand_reads(8, 6, 40, 120))
    stats = {}
    build_bwt_grouped(coll, PipelineConfig(m=32), GroupedConfig(cap=1000),
                      stats=stats, device="cpu")
    assert stats["cap"] == 1000 and stats["n_groups"] >= 1
    # the CPU is bound by the scans alone, and is not asked for memory
    assert grouped.default_cap(cpu, 10**6, 1024) == grouped.SCAN_ROWS - 4
    # a card: free memory less the resident text and fills and a chunk's
    # transients
    free, n, chunk = 20 * 2**30, 4 * 10**9, 1 << 27
    monkeypatch.setattr(api, "_device_memory_bytes", lambda dev: free)
    want = (free - n // 2 - chunk * grouped._SELECT_BYTES_PER_POS) \
        // grouped._GROUP_BYTES_PER_ROW
    assert grouped.default_cap(cuda, n, chunk) == want < grouped.SCAN_ROWS
    monkeypatch.setattr(api, "_device_memory_bytes", lambda dev: 1 << 60)
    assert grouped.default_cap(cuda, n, chunk) == grouped.SCAN_ROWS - 4
    monkeypatch.setattr(api, "_device_memory_bytes", lambda dev: n // 4)
    with pytest.raises(RuntimeError, match="device memory"):
        grouped.default_cap(cuda, n, chunk)


def test_api_routes_over_the_bound_to_grouped(monkeypatch, capsys):
    """Over the single-device bound api.build takes the grouped tier and
    writes the JAX grouped tier's bytes."""
    coll = SequenceCollection.from_reads(_rand_reads(6, 6, 40, 120))
    monkeypatch.setattr(api, "_SINGLE_ROWS", 64)
    stats = {}
    res = api.build(coll, PipelineConfig(m=32), device="cpu", verbose=True,
                    gcfg=GroupedConfig(cap=256), stats=stats)
    assert "route: grouped device-resident tier" in capsys.readouterr().err
    assert stats["n_groups"] >= 2 and stats["cap"] == 256
    assert "groups.select" in res.timings
    want = jgrouped.build_bwt_grouped(
        _jax_coll(coll), JaxConfig(m=32), jgrouped.GroupedConfig(cap=256))
    assert res.packed() == want.packed()
    np.testing.assert_array_equal(res.sharp_pos, want.sharp_pos)
    assert res.dollar_pos == want.dollar_pos
    g = golden_bwt(coll)
    np.testing.assert_array_equal(res.bwt6, g.bwt6)


def test_api_names_the_out_of_core_tier_on_overflow(monkeypatch, capsys):
    """A single node key exceeding the group cap (the all-A read of
    tests/test_grouped.py): the route names the overflow and the
    out-of-core tier, which builds golden's bytes; and past the grouped
    tier's position bound the route goes there straight."""
    coll = SequenceCollection.from_reads([np.zeros(3000, dtype=np.uint8)])
    monkeypatch.setattr(api, "_SINGLE_ROWS", 64)
    gcfg = GroupedConfig(cap=256)
    res = api.build(coll, PipelineConfig(m=32), device="cpu", gcfg=gcfg,
                    verbose=True)
    err = capsys.readouterr().err
    assert "grouped tier overflow" in err and "out-of-core" in err
    assert res.packed() == golden_bwt(coll).packed()
    monkeypatch.setattr(grouped, "MAX_N", 1000)
    res = api.build(coll, PipelineConfig(m=32), device="cpu", gcfg=gcfg,
                    verbose=True)
    err = capsys.readouterr().err
    assert "out-of-core" in err and "grouped" not in err
    assert res.packed() == golden_bwt(coll).packed()


def test_grouped_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coll = SequenceCollection.from_reads(_rand_reads(7, 2, 40, 60))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bwt_grouped(coll, PipelineConfig(m=32), GroupedConfig(cap=512))


# ---- the output on the device: packed words and sidecars ----

@pytest.mark.parametrize("genomes", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5])
def test_near_identical_genomes_in_three_groups_or_more(genomes, seed):
    """Near-identical genomes (synth_concat_codes: uniform bases, 0.2%
    substitutions) in at least three groups: the result holds packed
    words and sidecars, and packed(), the sidecars and bwt6 are
    golden's, the fused engine's and the out-of-core tier's."""
    codes, lengths = synth_concat_codes(0.012 * genomes, seed, genomes)
    coll = SequenceCollection.from_concat(codes, lengths)
    stats = {}
    # a third of the text a group: four groups at the fill target
    got = build_bwt_grouped(coll, PipelineConfig(m=32, check=True),
                            GroupedConfig(cap=coll.bwt_len // 3, chunk=4096),
                            stats=stats, device="cpu")
    assert stats["n_groups"] >= 3 and stats["attempts"] == 1
    assert got.packed_words is not None and got.packed_words.dtype == torch.int32
    g = golden_bwt(coll)
    packed = got.packed()
    assert packed == g.packed()
    np.testing.assert_array_equal(got.sharp_pos, g.sharp_pos)
    assert got.sharp_pos.shape[0] == genomes - 1
    assert got.dollar_pos == g.dollar_pos
    np.testing.assert_array_equal(got.bwt6, g.bwt6)
    assert packed == build_bwt(coll, PipelineConfig(m=32), device="cpu").packed()
    ooc = oocore.build_bwt_ooc(coll, PipelineConfig(m=32),
                               oocore.OocConfig(chunk=4096, n_buckets=8),
                               device="cpu")
    assert packed == ooc.packed() and ooc.dollar_pos == got.dollar_pos
    np.testing.assert_array_equal(ooc.sharp_pos, got.sharp_pos)


def test_retry_after_an_overflow_keeps_the_bytes():
    """A hot node key overflows the first plan's groups: the tier plans
    again with more groups, counts both attempts, and gives golden's
    bytes through the words it keeps."""
    rng = np.random.default_rng(8)
    read = np.concatenate([np.zeros(1731, np.uint8),
                           rng.choice(4, size=4300).astype(np.uint8)])
    coll = SequenceCollection.from_reads(
        [read, rng.choice(4, size=300).astype(np.uint8)])
    stats = {}
    got = build_bwt_grouped(coll, PipelineConfig(m=32, check=True),
                            GroupedConfig(cap=2048, chunk=1024), stats=stats,
                            device="cpu")
    assert stats["attempts"] > 1
    assert stats["groups_selected"] > stats["groups_classified"]
    assert got.counters["group_attempts"] == stats["attempts"]
    assert got.counters["groups"] == stats["n_groups"]
    g = golden_bwt(coll)
    assert got.packed() == g.packed()
    np.testing.assert_array_equal(got.sharp_pos, g.sharp_pos)
    assert got.dollar_pos == g.dollar_pos
    np.testing.assert_array_equal(got.bwt6, g.bwt6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_sp_string_is_the_out_of_core_tiers(seed):
    """The grouped tier's SP string, made from event ords and the packed
    text, equals oocore.sp_string on the T-padded codes, for events
    whose char k ahead is a base, a separator, '$' or past the text."""
    rng = np.random.default_rng(seed)
    coll = SequenceCollection.from_reads(_rand_reads(seed, 5, 40, 90))
    N, k = coll.bwt_len, 31
    ev = rng.choice(N - k - 1, size=40, replace=False).astype(np.int64)
    sep = coll.sep.astype(np.int64)
    ev[0] = N - 1 - k                    # the '$' ends its k-window
    ev[1] = sep[0] - k                   # a '#' ends this one
    ev = np.unique(ev)
    branch = np.arange(N - k, N, 3, dtype=np.int64)
    x2p = np.concatenate([coll.x2, np.full(32, 3, np.uint8)])
    want = oocore.sp_string([ev], branch, sep, x2p, N, k)
    x2ext = np.full(16 + N + 48, 3, np.uint8)
    x2ext[16 : 16 + N] = coll.x2
    words = torch.from_numpy(ops.pack_2bit_words_host(x2ext).view(np.int32))
    ords = (ev - grouped.ORD_BIAS).astype(np.int32)
    got = grouped._sp_string(ords, branch, words, torch.from_numpy(sep), N, k)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert {4, 5} <= set(want[1].tolist())


@pytest.mark.parametrize("n", [1, 63, 64, 200])
def test_char_counts_by_blocks(monkeypatch, n):
    """The check's character counts, a block of 64 positions at a time,
    are np.bincount's."""
    monkeypatch.setattr(ops, "PACK_BLOCK", 64)
    b = np.random.default_rng(n).integers(0, 6, size=n).astype(np.uint8)
    got = grouped._char_counts(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.bincount(b, minlength=6))
