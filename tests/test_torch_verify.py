"""The port's LF-walk verification against the JAX package's, on the
CPU: both regimes (full LF permutation, sampled occ table), the native
walker against the NumPy walk, and the occ tables."""

import dataclasses

import numpy as np
import pytest

from debwt_tpu import verify as jverify
from debwt_tpu.golden import golden_bwt as jax_golden
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import verify
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.io import native
from debwt_tpu_torch.kernels import _build
from debwt_tpu_torch.pipeline import build_bwt
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection


def _coll(seed, n=4, size=150):
    rng = np.random.default_rng(seed)
    return SequenceCollection.from_reads(
        ["".join(rng.choice(list("ACGT"), size=size)) for _ in range(n)])


def _corrupt(g, nth, flip):
    bad = g.bwt6.copy()
    bad[int(np.nonzero(bad < 4)[0][nth])] ^= flip
    return dataclasses.replace(g, bwt6=bad)


@pytest.mark.parametrize("fast_n", [1 << 27, 1], ids=["full_lf", "sampled_occ"])
@pytest.mark.parametrize("walker", ["native", "numpy"])
def test_lf_verify_accepts_golden_rejects_corrupted(monkeypatch, fast_n, walker):
    """True on a golden result, false on one with a flipped character,
    in both regimes and with both walkers; the JAX package agrees."""
    coll = _coll(0)
    g = golden_bwt(coll)
    bad = _corrupt(g, 11, 2)
    monkeypatch.setattr(verify, "_FAST_N", fast_n)
    monkeypatch.setattr(jverify, "_FAST_N", fast_n)
    if walker == "numpy":
        monkeypatch.setattr(native, "has_lf_walk", lambda: False)
        monkeypatch.setattr(native, "_lib", lambda: 1 / 0)   # never reached
    assert verify.lf_verify(g, coll, sample=8) is True
    assert verify.lf_verify(bad, coll, sample=8) is False
    jcoll = JaxCollection(x2=coll.x2, sep=coll.sep)
    assert jverify.lf_verify(jax_golden(jcoll), jcoll, sample=8) is True
    assert jverify.lf_verify(bad, jcoll, sample=8) is False


@pytest.mark.parametrize("fast_n", [1 << 27, 1], ids=["full_lf", "sampled_occ"])
def test_lf_verify_bounded_walk_sees_only_the_last_steps(monkeypatch, fast_n):
    """max_steps bounds the walk to the text's last characters, natively
    and in NumPy alike."""
    coll = _coll(1, n=3, size=200)
    g = golden_bwt(coll)
    monkeypatch.setattr(verify, "_FAST_N", fast_n)
    # a wrong text character early in the text: a short walk from the
    # end never reaches it, the full walk does
    x6 = coll.x6.copy()
    x6[5] = (x6[5] + 1) % 4
    other = type("C", (), {"x6": x6})()
    for numpy_walk in (False, True):
        if numpy_walk:
            monkeypatch.setattr(native, "has_lf_walk", lambda: False)
        assert verify.lf_verify(g, other, max_steps=50, sample=8) is True
        assert verify.lf_verify(g, other, sample=8) is False
        assert verify.lf_verify(g, coll, max_steps=10**9, sample=8) is True


def test_lf_verify_on_a_built_result():
    coll = _coll(2, n=6)
    r = build_bwt(coll, PipelineConfig(m=20), device="cpu")
    assert verify.lf_verify(r, coll)


@pytest.mark.parametrize("sample", [1, 4, 32])
def test_occ_tables_match_jax(sample):
    g = golden_bwt(_coll(3, n=3, size=300))
    occ6, counts = verify._build_occ6(g.bwt6, sample)
    jocc6, jcounts = jverify._build_occ6(g.bwt6, sample)
    assert occ6.dtype == jocc6.dtype
    np.testing.assert_array_equal(occ6, jocc6)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(counts, np.bincount(g.bwt6, minlength=6))
    # the ACGT view of the same table and the ACGT offsets
    occ, C = verify.build_occ(g.bwt6, sample)
    jocc, jC = jverify.build_occ(g.bwt6, sample)
    assert (occ.dtype, occ.shape, C.dtype) == (jocc.dtype, jocc.shape, jC.dtype)
    np.testing.assert_array_equal(occ, jocc)
    np.testing.assert_array_equal(C, jC)


@pytest.mark.parametrize("dtype", [np.uint32, np.int64])
@pytest.mark.parametrize("n,sample", [(0, 32), (1, 32), (31, 32), (32, 32),
                                      (1000, 32), (1001, 3), (777, 1)])
def test_native_occ_table_matches_numpy(n, sample, dtype):
    """The native one-pass occ table equals the blocked NumPy one, in
    both entry types, on ragged lengths; bytes over 5 count nowhere."""
    rng = np.random.default_rng(n + sample)
    bwt6 = rng.integers(0, 8, size=n, dtype=np.uint8)
    occ6, counts = native.occ6(bwt6, sample, dtype)
    want, wcounts = verify._build_occ6_numpy(bwt6, sample, dtype)
    assert occ6.dtype == want.dtype == dtype
    np.testing.assert_array_equal(occ6, want)
    np.testing.assert_array_equal(counts, wcounts)
    np.testing.assert_array_equal(
        counts, [np.count_nonzero(bwt6 == c) for c in range(6)])


def test_native_walker_builds_into_the_build_directory():
    """The walker's library is built by the host compiler at first use,
    into the git-ignored build directory."""
    coll = _coll(4)
    assert verify.lf_verify(golden_bwt(coll), coll)
    lib = _build.lib_path("lf_walk")
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    assert lib.parent.name == "build" and lib.parent.parent.name == "csrc"


def test_native_walker_that_fails_to_build_raises(monkeypatch, tmp_path):
    """No quiet turn to the Python loop: a failed build is an error."""
    coll = _coll(5)
    g = golden_bwt(coll)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "CXX_FLAGS", ("-std=c++17", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="build failed for lf_walk"):
        verify.lf_verify(g, coll)
    monkeypatch.setattr(_build, "CXX_FLAGS", ("-std=c++17", "-O2", "-shared", "-fPIC"))
    monkeypatch.setattr(_build, "_cxx", lambda: str(tmp_path / "no-compiler"))
    with pytest.raises(OSError):
        verify.lf_verify(g, coll)


def test_native_walker_checks_its_arrays():
    lf = np.arange(8, dtype=np.int64)
    b = np.zeros(8, np.uint8)
    with pytest.raises(ValueError, match="int64"):
        native.lf_walk(lf.astype(np.int32), b, b, 8, 0)
    with pytest.raises(ValueError, match="out of range"):
        native.lf_walk(lf, b, b, 9, 0)
    with pytest.raises(ValueError, match="out of range"):
        native.lf_walk(lf, b, b[:4], 4, 0)
    with pytest.raises(ValueError, match="occ6"):
        native.lf_walk_occ(b, b, np.zeros((2, 6), np.int32),
                           np.zeros(7, np.int64), 8, 8, 0)
