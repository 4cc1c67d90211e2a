"""The port's CUDA kernels against their plain PyTorch versions, and the
main path on the card. Marked `gpu`: each test skips where no CUDA card
is present (decided in the `cuda` fixture, never at import).

This file imports neither jax nor the JAX package, so on a machine with
a card and no jax it runs without the repo's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from debwt_tpu_torch import api, count_kmers, ops
from debwt_tpu_torch import grouped as grouped_mod
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.grouped import GroupedConfig, build_bwt_grouped
from debwt_tpu_torch.kernels import seg_or
from debwt_tpu_torch.kernels import window_keys as wk
from debwt_tpu_torch.oocore import OocConfig, build_bwt_ooc
from debwt_tpu_torch.ops import pack_2bit_words, pack_2bit_words_host
from debwt_tpu_torch.pipeline import _bucket, _pow2, build_bwt
from debwt_tpu_torch.special import build_special
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection
from debwt_tpu_torch.verify import lf_verify

pytestmark = pytest.mark.gpu

PALLAS_TILE = 8192   # the JAX kernels' tile (tests/test_kernels.py shapes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def gen(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    return g


@pytest.mark.parametrize(
    "n_out,w",
    [(5000, 32), (5000, 31), (PALLAS_TILE, 24), (PALLAS_TILE + 1, 23),
     (3 * PALLAS_TILE + 17, 29), (20000, 12), (9000, 2), (1, 32), (1025, 1)],
)
def test_window_keys_kernel_matches_plain(cuda, gen, n_out, w):
    x = torch.randint(0, 4, (n_out + w - 1,), generator=gen, device=cuda,
                      dtype=torch.uint8)
    before = wk.window_keys.launches
    got = wk.window_keys(x, w, n_out)
    assert wk.window_keys.launches == before + 1
    assert torch.equal(got, wk.window_keys_plain(x, w, n_out))


@pytest.mark.parametrize(
    "n_out,w",
    [(5000, 32), (5000, 31), (PALLAS_TILE, 24), (PALLAS_TILE + 1, 23),
     (3 * PALLAS_TILE + 17, 29), (20000, 12), (9000, 2), (1, 32), (1025, 1),
     (4081, 16), (33, 32), (100, 5), (2048, 32), (2049, 32)],
)
def test_window_keys_packed_kernel_matches_plain(cuda, gen, n_out, w):
    """The packed entry, also where the last word is partial and where
    W[j+1] or W[j+2] would lie past the end of the words."""
    x = torch.randint(0, 4, (n_out + w - 1,), generator=gen, device=cuda,
                      dtype=torch.uint8)
    x2w = pack_2bit_words(x)
    before = wk.window_keys.launches
    got = wk.window_keys_packed(x2w, w, n_out)
    assert wk.window_keys.launches == before + 1
    assert torch.equal(got, wk.window_keys_packed_plain(x2w, w, n_out))
    assert torch.equal(got, wk.window_keys_plain(x, w, n_out))
    assert torch.equal(got, wk.window_keys_words_replay(x2w, w, n_out))


@pytest.mark.parametrize("offset", [1, 3, 16, 17])
@pytest.mark.parametrize("w", [32, 13])
def test_window_keys_kernel_on_misaligned_slice(cuda, gen, offset, w):
    """uint8 codes that start at an odd byte offset of their tensor."""
    n_out = 3 * 2048 + 5
    x = torch.randint(0, 4, (offset + n_out + w - 1,), generator=gen,
                      device=cuda, dtype=torch.uint8)
    got = wk.window_keys(x[offset:], w, n_out)
    assert torch.equal(got, wk.window_keys_plain(x[offset:].clone(), w, n_out))


def test_window_keys_kernel_tail_isolated(cuda, gen):
    n_out, w = 6000, 32
    base = torch.randint(0, 4, (n_out + w - 1 + 500,), generator=gen,
                         device=cuda, dtype=torch.uint8)
    other = base.clone()
    other[n_out + w - 1:] = (other[n_out + w - 1:] + 1) % 4
    assert torch.equal(wk.window_keys(base, w, n_out),
                       wk.window_keys(other, w, n_out))


@pytest.mark.parametrize("w", [2, 12, 24, 31, 32])
@pytest.mark.parametrize("n_codes", [37, 4096, 200_003])
def test_window_keys_at_kernel_matches_plain(cuda, gen, w, n_codes):
    """The gathered entry at random positions in no order, the first and
    last whose window fits, windows that run past the words and a
    negative position (both read code 0 there)."""
    x = torch.randint(0, 4, (n_codes,), generator=gen, device=cuda,
                      dtype=torch.uint8)
    x2w = pack_2bit_words(x)
    n_out = n_codes - w + 1
    pos = torch.cat([
        torch.randint(0, n_out, (5000,), generator=gen, device=cuda),
        torch.tensor([0, n_out - 1, n_codes - 1, 16 * x2w.shape[0] + 40, -5],
                     device=cuda)])
    before = wk.window_keys_at.launches
    got = wk.window_keys_at(x2w, pos, w)
    assert wk.window_keys_at.launches == before + 1
    assert torch.equal(got, wk.window_keys_at_plain(x2w, pos, w))
    assert torch.equal(got[:5000], wk.window_keys_plain(x, w, n_out)[pos[:5000]])


@pytest.mark.parametrize("stop", [1 << 6, 1 << 29])
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize(
    "R", [1, 127, seg_or.TILE, seg_or.TILE + 1, seg_or.TILE + 2,
          seg_or.TILE + 3, 3 * seg_or.TILE + 17, PALLAS_TILE + 1, 70001,
          (32 * 32 + 5) * seg_or.TILE + 1],
)
@pytest.mark.parametrize("p_stop", [0.05, 0.0])
def test_seg_scan_or_kernel_matches_plain(cuda, gen, R, prefix, stop, p_stop):
    """p_stop = 0: one segment spans every tile (the look-back windows
    chain). R mod 4 takes every value; the largest R has more tiles than
    32 look-back windows."""
    bits = torch.randint(0, stop, (R,), generator=gen, device=cuda,
                         dtype=torch.int32)
    is_stop = torch.rand(R, generator=gen, device=cuda) < p_stop
    is_stop[0 if prefix else -1] = True
    words = bits | (is_stop.to(torch.int32) * stop)
    before = seg_or.seg_scan_or.launches
    got = seg_or.seg_scan_or(words, stop_bit=stop, prefix=prefix)
    assert seg_or.seg_scan_or.launches == before + 1
    assert torch.equal(got, seg_or.seg_scan_or_plain(words, stop, prefix))


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_seg_scan_or_kernel_on_misaligned_slice(cuda, gen, offset, prefix):
    """Words that start off a 16-byte boundary take the scalar loads."""
    stop = 1 << 6
    R = 5 * seg_or.TILE + 9
    words = torch.randint(0, 2 * stop, (offset + R,), generator=gen,
                          device=cuda, dtype=torch.int32)
    words[offset if prefix else -1] |= stop
    got = seg_or.seg_scan_or(words[offset:], stop_bit=stop, prefix=prefix)
    want = seg_or.seg_scan_or_plain(words[offset:].clone(), stop, prefix)
    assert torch.equal(got, want)


def test_seg_scan_or_kernel_repeated_launches(cuda, gen):
    """Every launch gets fresh descriptors and a fresh ticket."""
    stop = 1 << 29
    R = 300 * seg_or.TILE + 2
    words = torch.randint(0, stop, (R,), generator=gen, device=cuda,
                          dtype=torch.int32)
    words[0] |= stop
    want = seg_or.seg_scan_or_plain(words, stop, True)
    for _ in range(5):
        assert torch.equal(seg_or.seg_scan_or(words, stop, True), want)


@pytest.mark.parametrize("m", [12, 24, 32])
def test_build_bwt_on_card_matches_golden(cuda, m):
    rng = np.random.default_rng(m)
    frags = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(4)]
    reads = ["".join(rng.choice(frags) for _ in range(5)) for _ in range(12)]
    coll = SequenceCollection.from_reads(reads)
    wk.window_keys.launches = seg_or.seg_scan_or.launches = 0
    r = build_bwt(coll, PipelineConfig(m=m, check=True))
    assert (wk.window_keys.launches, seg_or.seg_scan_or.launches) == (1, 4)
    g = golden_bwt(coll)
    assert r.packed() == g.packed()
    np.testing.assert_array_equal(r.sharp_pos, g.sharp_pos)
    assert r.dollar_pos == g.dollar_pos


def test_fused_build_reads_the_device_codes_once(cuda, monkeypatch):
    """A fused api.build launches kernel 1 once, through its byte entry,
    on the device codes the engine keeps (16-byte aligned, so the
    loader's vector path is the one taken), never through the packed
    entry; its bytes and sidecars are the CPU build's."""
    rng = np.random.default_rng(16)
    frags = ["".join(rng.choice(list("ACGT"), size=300)) for _ in range(6)]
    reads = ["".join(rng.choice(frags) for _ in range(4)) + "".join(
        rng.choice(list("ACGT"), size=int(rng.integers(1, 50))))
        for _ in range(40)]
    coll = SequenceCollection.from_reads(reads)
    seen = []

    def byte_entry(x2, w, n_out):
        seen.append((x2.device.type, x2.dtype, x2.data_ptr() % 16,
                     x2.shape[0], n_out))
        return wk.window_keys(x2, w, n_out)

    def packed_entry(*args):
        raise AssertionError("the fused build read packed words")

    monkeypatch.setattr(ops, "_window_keys", byte_entry)
    monkeypatch.setattr(ops, "_window_keys_packed", packed_entry)
    before = wk.window_keys.launches
    r = api.build(coll, PipelineConfig(m=32), device=cuda)
    assert wk.window_keys.launches == before + 1
    N_cap = _bucket(coll.bwt_len)
    assert seen == [("cuda", torch.uint8, 0, N_cap + 31, N_cap)]
    want = api.build(coll, PipelineConfig(m=32), device="cpu")
    assert r.packed() == want.packed()
    np.testing.assert_array_equal(r.sharp_pos, want.sharp_pos)
    assert r.dollar_pos == want.dollar_pos


def _repeat_reads(seed, n_reads=12):
    rng = np.random.default_rng(seed)
    frags = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(4)]
    return ["".join(rng.choice(frags) for _ in range(5)) for _ in range(n_reads)]


@pytest.mark.parametrize("m,cap,chunk", [(12, 512, 256), (24, 1024, 512),
                                         (32, 512, 256), (32, 100_000, 4096)])
def test_grouped_on_card_matches_golden(cuda, m, cap, chunk):
    """The grouped tier on the card: golden bytes, and both kernels
    launched as the plan says (once a chunk of every group, and three
    scans a group)."""
    coll = SequenceCollection.from_reads(_repeat_reads(m + cap))
    stats = {}
    wk.window_keys.launches = seg_or.seg_scan_or.launches = 0
    r = build_bwt_grouped(coll, PipelineConfig(m=m, check=True),
                          GroupedConfig(cap=cap, chunk=chunk), stats=stats)
    G, n_chunks = stats["n_groups"], stats["n_chunks"]
    assert stats["attempts"] == 1 and (G >= 2) == (cap < 100_000)
    assert wk.window_keys.launches == G * n_chunks
    assert seg_or.seg_scan_or.launches == G * n_chunks + 3 * G
    assert stats["launches"] == {"window_keys": G * n_chunks,
                                 "seg_scan_or": G * n_chunks + 3 * G}
    g = golden_bwt(coll)
    assert r.packed() == g.packed()
    np.testing.assert_array_equal(r.sharp_pos, g.sharp_pos)
    assert r.dollar_pos == g.dollar_pos


def _classify_group(*args):
    """The grouped classification with its counts on the host: (fill2,
    b_key, b_sgc, b_pos, n_g, E_g)."""
    fill2, rows, n_valid = grouped_mod._classify_rows(*args)
    b_key, b_sgc, b_pos = grouped_mod._event_rows(*rows)
    return fill2, b_key, b_sgc, b_pos, int(n_valid), b_key.shape[0]


def _one_group_rows(coll, m):
    """The select buffers and special rows of a one-group plan of coll,
    built on the CPU as build_bwt_grouped builds them."""
    N = coll.bwt_len
    C = 1024
    n_chunks = -(-N // C)
    E = C + m + 15
    E += (-E) % 16
    x2ext = np.full(16 + (n_chunks - 1) * C + E, 3, np.uint8)
    x2ext[16 : 16 + N] = coll.x2
    x2w = torch.from_numpy(pack_2bit_words_host(x2ext).view(np.int32))
    cap = _bucket(N + 64)
    cap += (-cap) % 4
    _sep_d, seps = grouped_mod._chunk_seps(coll.sep.astype(np.int64), "cpu", C,
                                           n_chunks, m - 1)
    bkey, bord, bf8, n = grouped_mod._select_group(
        x2w, seps, N, 0, 0, True, m, C, cap, E)
    sp = build_special(coll, m)
    n_spec = sp.spec_tfill.shape[0]
    ns_cap = _pow2(max(16, n_spec))

    def pad(a, fillv):
        out = np.full(ns_cap, fillv, dtype=a.dtype)
        out[:n_spec] = a
        return torch.from_numpy(out)

    spec = (pad(((sp.spec_tfill << np.uint64(2)) | np.uint64(3)).view(np.int64), -1),
            pad((np.arange(n_spec) + grouped_mod.ORD_SPEC - grouped_mod.ORD_BIAS)
                .astype(np.int32), np.int32(grouped_mod.PAD_ORD)),
            pad(sp.spec_bwt6, np.uint8(0)))
    return (bkey, bord, bf8), spec, cap, ns_cap, n


@pytest.mark.parametrize("m", [24, 32])
def test_classify_positions_past_2_31_on_card(cuda, m):
    """The grouped classification with every main row's position moved
    past 2^31 (int32 ords turned positive, as a text over 2.15 Gbp gives
    them): on the card it equals the same call on the CPU, with b_pos
    int64 at or over 2^31, and launches kernel 2 three times."""
    coll = SequenceCollection.from_reads(_repeat_reads(m))
    (bkey, bord, bf8), spec, cap, ns_cap, n = _one_group_rows(coll, m)
    main = bord < grouped_mod.ORD_SPEC - grouped_mod.ORD_BIAS
    assert int(main.sum()) == n > 0
    shift = (1 << 31) + (1 << 20)
    bord = torch.where(main, bord.to(torch.int64) + shift, bord).to(torch.int32)
    assert (bord[main] >= 0).all()
    args = (bkey, bord, bf8) + spec
    want = _classify_group(*args, m, cap, ns_cap)
    before = seg_or.seg_scan_or.launches
    got = _classify_group(*(a.to(cuda) for a in args), m, cap, ns_cap)
    assert seg_or.seg_scan_or.launches == before + 3
    assert got[3].dtype == torch.int64 and bool((want[3] >= 1 << 31).all())
    assert got[4:] == want[4:]
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a.cpu(), b)


def test_api_routes_to_grouped_on_card(cuda, monkeypatch):
    coll = SequenceCollection.from_reads(_repeat_reads(7))
    monkeypatch.setattr(api, "_SINGLE_ROWS", 64)
    stats = {}
    r = api.build(coll, PipelineConfig(m=32, check=True),
                  gcfg=GroupedConfig(cap=512), stats=stats)
    assert "groups.select" in r.timings and stats["cap"] == 512
    assert r.packed() == golden_bwt(coll).packed()


@pytest.mark.parametrize("m,fields", [
    (12, dict(chunk=256, n_buckets=8)), (24, dict(chunk=512, n_buckets=4)),
    (32, dict(chunk=256, n_buckets=64)),
    (32, dict(chunk=512, n_buckets=2, bucket_cap=32)),
])
def test_ooc_on_card_matches_golden(cuda, m, fields):
    """The out-of-core tier on the card: golden bytes, kernel 1 once a
    chunk, its gathered form once a device classification (and once an
    oversized bucket's cap rows) and kernel 2 three times a device
    classification."""
    coll = SequenceCollection.from_reads(_repeat_reads(m + fields["n_buckets"]))
    stats = {}
    wk.window_keys.launches = wk.window_keys_at.launches = 0
    seg_or.seg_scan_or.launches = 0
    r = build_bwt_ooc(coll, PipelineConfig(m=m, check=True), OocConfig(**fields),
                      stats=stats)
    n_at = stats["launches"]["window_keys_at"]
    want = {"window_keys": stats["n_chunks"], "window_keys_at": n_at,
            "seg_scan_or": 3 * stats["classifications"]}
    assert stats["n_chunks"] > 1 and stats["classifications"] >= 1
    assert (wk.window_keys.launches, wk.window_keys_at.launches,
            seg_or.seg_scan_or.launches) == tuple(want.values())
    assert stats["launches"] == want
    if "bucket_cap" in fields:
        assert n_at > stats["classifications"]
    else:
        assert n_at == stats["classifications"]
    assert (stats["oversized_buckets"] > 0) == ("bucket_cap" in fields)
    g = golden_bwt(coll)
    assert r.packed() == g.packed()
    np.testing.assert_array_equal(r.sharp_pos, g.sharp_pos)
    assert r.dollar_pos == g.dollar_pos


def test_ooc_on_card_resumes_mid_pass_b(cuda, monkeypatch, tmp_path):
    from debwt_tpu_torch import oocore

    coll = SequenceCollection.from_reads(_repeat_reads(11))
    ooc = OocConfig(chunk=256, n_buckets=8, spill_dir=str(tmp_path / "ck"),
                    checkpoint=True)
    real = oocore._classify_bucket
    calls = {"n": 0}

    def crash_on_4th(*a):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("simulated crash")
        return real(*a)

    monkeypatch.setattr(oocore, "_classify_bucket", crash_on_4th)
    with pytest.raises(RuntimeError, match="simulated crash"):
        build_bwt_ooc(coll, PipelineConfig(m=32), ooc)
    monkeypatch.setattr(oocore, "_classify_bucket", real)
    stats = {}
    r = build_bwt_ooc(coll, PipelineConfig(m=32), ooc, stats=stats)
    assert stats["launches"]["window_keys"] == 0
    assert stats["launches"]["window_keys_at"] == stats["classifications"]
    assert stats["launches"]["seg_scan_or"] == 3 * stats["classifications"]
    assert r.packed() == golden_bwt(coll).packed()
    assert list((tmp_path / "ck").glob("bk*")) == []


def test_api_routes_to_ooc_on_card(cuda, monkeypatch):
    from debwt_tpu_torch import grouped

    coll = SequenceCollection.from_reads(_repeat_reads(5))
    monkeypatch.setattr(api, "_SINGLE_ROWS", 64)
    monkeypatch.setattr(grouped, "MAX_N", 64)
    stats = {}
    r = api.build(coll, PipelineConfig(m=32, check=True), stats=stats)
    assert stats["n_buckets"] == 64 and "pass B (bucket sorts)" in r.timings
    assert r.packed() == golden_bwt(coll).packed()


@pytest.mark.parametrize("fast_n", [1 << 27, 1], ids=["full_lf", "sampled_occ"])
def test_lf_verify_on_card_result(cuda, monkeypatch, fast_n):
    import dataclasses

    from debwt_tpu_torch import verify

    monkeypatch.setattr(verify, "_FAST_N", fast_n)
    coll = SequenceCollection.from_reads(_repeat_reads(3))
    r = build_bwt(coll, PipelineConfig(m=32))
    assert lf_verify(r, coll)
    bad = r.bwt6.copy()
    bad[int(np.nonzero(bad < 4)[0][5])] ^= 1
    assert not lf_verify(dataclasses.replace(r, packed_words=None, _bwt6=bad), coll)


@pytest.mark.parametrize("m", [12, 20, 32])
def test_count_kmers_on_card_matches_host_count(cuda, m):
    # T runs: at m = 32 keys with the top bit set, in unsigned order
    reads = _repeat_reads(m) + ["T" * 80 + "ACGT" * 10]
    coll = SequenceCollection.from_reads(reads)
    want = {}
    for r in reads:
        for i in range(len(r) - m + 1):
            v = 0
            for ch in r[i : i + m]:
                v = (v << 2) | "ACGT".index(ch)
            want[v] = want.get(v, 0) + 1
    wk.window_keys.launches = 0
    kmers, counts = count_kmers(coll, m)
    assert wk.window_keys.launches == 1
    assert kmers.dtype == np.uint64
    assert [int(v) for v in kmers] == sorted(want)
    assert [int(c) for c in counts] == [want[v] for v in sorted(want)]


@pytest.mark.parametrize("m", [12, 32])
def test_dist_one_rank_nccl_on_card_matches_fused(cuda, m):
    """The multi-device tier as one rank over NCCL on the card: kernel 1
    once, the fused engine's bytes. The one-rank group it makes is torn
    down after."""
    import torch.distributed as tdist

    from debwt_tpu_torch.parallel import dist_build_bwt, make_mesh

    reads = _repeat_reads(m) + ["A" * 40 + "T" * 40 + "C" * 40]
    coll = SequenceCollection.from_reads(reads)
    mesh = make_mesh(1)
    try:
        assert (mesh.n, mesh.backend, mesh.device.type) == (1, "nccl", "cuda")
        wk.window_keys.launches = seg_or.seg_scan_or.launches = 0
        r = dist_build_bwt(coll, PipelineConfig(m=m, check=True), mesh)
        assert (wk.window_keys.launches, seg_or.seg_scan_or.launches) == (1, 0)
    finally:
        tdist.destroy_process_group()
    f = build_bwt(coll, PipelineConfig(m=m))
    assert r.packed() == f.packed()
    np.testing.assert_array_equal(r.sharp_pos, f.sharp_pos)
    assert r.dollar_pos == f.dollar_pos


def test_cli_grouped_route_on_card(cuda, monkeypatch, tmp_path, capsys):
    """The CLI on the card, routed to the grouped tier by the variables
    (DEBWT_SINGLE_MAX_ROWS under the rows, DEBWT_GROUPED_CAP 512): the
    route line names it, the kernels launch, the files are golden's."""
    from debwt_tpu_torch.cli import main as cli_main
    from debwt_tpu_torch.io import read_bwt

    reads = _repeat_reads(7)
    fa = tmp_path / "in.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    monkeypatch.setenv("DEBWT_SINGLE_MAX_ROWS", "64")
    monkeypatch.setenv("DEBWT_GROUPED_CAP", "512")
    wk.window_keys.launches = seg_or.seg_scan_or.launches = 0
    obj = tmp_path / "out.bwt"
    assert cli_main(["-o", str(obj), "--check", "--verify", str(fa)]) == 0
    err = capsys.readouterr().err
    assert "route: grouped device-resident tier" in err
    assert "LF invertibility: OK" in err
    # 5 groups of one chunk: kernel 1 once a group, kernel 2 four times
    assert (wk.window_keys.launches, seg_or.seg_scan_or.launches) == (5, 20)
    coll = SequenceCollection.from_reads(reads)
    g = golden_bwt(coll)
    assert obj.read_bytes() == g.packed()
    bwt6, sharp, dollar = read_bwt(str(obj), coll.bwt_len)
    np.testing.assert_array_equal(sharp, g.sharp_pos)
    assert dollar == g.dollar_pos
