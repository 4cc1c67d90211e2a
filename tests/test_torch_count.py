"""The port's k-mer counting against the JAX package's on the CPU, the
Jellyfish dump ingest, and the port's copies of the NumPy model and the
N-removal tool."""

import numpy as np
import pytest
import torch

import debwt_tpu_torch
from debwt_tpu import count as jcount
from debwt_tpu import transfer_n as jax_transfer_n
from debwt_tpu.model import build_model as jax_build_model
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import count, ops, transfer_n
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.model import build_model
from debwt_tpu_torch.types import SequenceCollection

import jax.numpy as jnp


def _coll(seed, top_t=False):
    rng = np.random.default_rng(seed)
    reads = [rng.choice(4, size=int(rng.integers(60, 200))).astype(np.uint8)
             for _ in range(5)]
    reads.append(np.concatenate([reads[0][:80], reads[1][:70]]))   # repeats
    if top_t:   # T runs: keys with the top bit set at m = 32
        reads += [np.concatenate([np.full(50, 3, np.uint8), reads[2][:60],
                                  np.full(40, 3, np.uint8)])] * 2
    return SequenceCollection.from_reads(reads)


def _jax(coll):
    return JaxCollection(x2=coll.x2, sep=coll.sep)


@pytest.mark.parametrize("top_t", [False, True])
@pytest.mark.parametrize("m", [12, 20, 32])
def test_count_kmers_matches_jax(m, top_t):
    coll = _coll(m, top_t)
    keys, counts = count.count_kmers(coll, m, device="cpu")
    jkeys, jcounts = jcount.count_kmers(_jax(coll), m)
    assert keys.dtype == jkeys.dtype == np.uint64
    assert counts.dtype == jcounts.dtype == np.int64
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(counts, jcounts)
    assert (np.diff(keys.astype(object)) > 0).all()    # unsigned order
    assert counts.sum() == coll.bwt_len - coll.n_reads * m
    if top_t and m == 32:
        assert (keys >> np.uint64(63)).any() and not (keys >> np.uint64(63)).all()


@pytest.mark.parametrize("m", [12, 32])
def test_sorted_edges_match_jax(m):
    coll = _coll(7, top_t=True)
    N = coll.bwt_len
    x2p = np.concatenate([coll.x2, np.full(32, 3, np.uint8)])
    sep = torch.from_numpy(coll.sep.astype(np.int64))
    dist = count.distance_to_separator(sep, N)
    jdist = jcount.distance_to_separator(
        jnp.asarray(coll.sep.astype(np.int32)), jnp.zeros(N, jnp.int32))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    n_edges = N - coll.n_reads * m
    key, pos = count.extract_and_sort_edges(torch.from_numpy(x2p), dist, m, n_edges)
    jhi, jlo, jpos = jcount.extract_and_sort_edges(jnp.asarray(x2p), jdist, m, n_edges)
    np.testing.assert_array_equal(
        key.numpy(), ops.keys_from_pair(np.asarray(jhi), np.asarray(jlo)))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_count_kmers_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        debwt_tpu_torch.count_kmers(_coll(0), 20)


def test_read_kmer_dump_round_trip(tmp_path):
    """A reference-format dump of the device counts reads back as the
    same (keys, counts), in any line order, with the 'N'->G quirk, and
    as the JAX package reads it."""
    coll = _coll(3)
    m = 20
    keys, counts = debwt_tpu_torch.count_kmers(coll, m=m, device="cpu")
    b = np.array(list("ACGT"))
    lines = []
    for k, c in zip(keys.tolist(), counts.tolist()):
        s = "".join(b[(k >> (2 * (m - 1 - j))) & 3] for j in range(m))
        lines.append(f"{s}\t{c}")
    np.random.default_rng(1).shuffle(lines)
    i = lines[0].index("G")
    lines[0] = lines[0][:i] + "N" + lines[0][i + 1:]
    p = tmp_path / "dump.txt"
    p.write_text("\n".join(lines) + "\n")
    keys2, counts2 = debwt_tpu_torch.read_kmer_dump(str(p), m=m)
    np.testing.assert_array_equal(keys2, keys)
    np.testing.assert_array_equal(counts2, counts)
    jkeys, jcounts = jcount.read_kmer_dump(str(p), m=m)
    np.testing.assert_array_equal(keys2, jkeys)
    np.testing.assert_array_equal(counts2, jcounts)
    with pytest.raises(ValueError, match="length"):
        count.read_kmer_dump(str(p), m=m + 1)
    (tmp_path / "empty.txt").write_text("")
    assert count.read_kmer_dump(str(tmp_path / "empty.txt"))[0].shape == (0,)


@pytest.mark.parametrize("m", [12, 32])
def test_model_copy_matches_jax_model_and_golden(m):
    coll = _coll(11)
    got, tr = build_model(coll, m=m, trace=True)
    want, jtr = jax_build_model(_jax(coll), m=m, trace=True)
    np.testing.assert_array_equal(got.bwt6, want.bwt6)
    np.testing.assert_array_equal(got.bwt6, golden_bwt(coll).bwt6)
    for f in ("dist", "node_keys", "node_cnt", "node_multi_in", "node_multi_out",
              "node_pred", "sp_positions", "sp6", "unit_start", "unit_is_special"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jtr, f), err_msg=f)


def test_transfer_n_copy_writes_the_same_file(tmp_path, capsys):
    rng = np.random.default_rng(2)
    src = tmp_path / "in.fa"
    with open(src, "w") as f:
        for i in range(4):
            f.write(f">r{i} x\n" + "".join(rng.choice(list("ACGTNRYK"), size=150)) + "\n")
    assert transfer_n.main([str(src), str(tmp_path / "port.fa"), "--seed", "4"]) == 0
    assert "min read length 150" in capsys.readouterr().err
    assert jax_transfer_n.main([str(src), str(tmp_path / "jax.fa"), "--seed", "4"]) == 0
    out = (tmp_path / "port.fa").read_text()
    assert out == (tmp_path / "jax.fa").read_text()
    assert set(out.replace("\n", "")) - set(">r0123") <= set("ACGT")
