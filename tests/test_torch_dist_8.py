"""The port's multi-device tier at 8 gloo ranks (one launch of
tests/torch_dist_worker.py) against the JAX tier on the 8-device CPU
mesh and golden: tests/test_dist.py's 8-device cases, and stage by
stage against the JAX tier's DEBUG capture (per shard the SP and blue
flags, per rank the node table, its counts, flags and coordinates)."""

import numpy as np
import pytest

import debwt_tpu.parallel.dist as jdist
from debwt_tpu.parallel import make_mesh as jax_mesh
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.ops import keys_from_pair
from debwt_tpu_torch.types import SequenceCollection

from torch_dist_worker import every_rank, launch, rand_reads

N = 8


def repeat_reads():
    rng = np.random.default_rng(2)
    frags = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(4)]
    return ["".join(rng.choice(frags) for _ in range(5)) for _ in range(5)]


def skewed_reads():
    rng = np.random.default_rng(9)
    frag = "".join(rng.choice(list("ACGT"), size=40))
    return ["A" * 120 + frag + "A" * 60, frag + "A" * 80 + frag, "A" * 200,
            frag * 4, "".join(rng.choice(list("ACGT"), size=150))]


def pathological_reads():
    """Nearly every key starts with a hot 8-char prefix (mutated
    poly-A): the 16-char splitters must still spread the keys."""
    rng = np.random.default_rng(7)
    polyA = np.zeros(30_000, dtype=np.uint8)
    mut = rng.choice(len(polyA) - 64, size=3000, replace=False) + 32
    polyA[mut] = rng.integers(1, 4, size=3000)
    return ["".join("ACGT"[c] for c in polyA),
            "".join(rng.choice(list("ACGT"), size=500)), "A" * 400,
            "".join(rng.choice(list("ACGT"), size=300))]


def split_reads():
    return rand_reads(3, n=6, lo=50, hi=200)


INPUTS = {"rand": rand_reads(8), "repeat": repeat_reads(),
          "skewed": skewed_reads(), "pathological": pathological_reads(),
          "split": split_reads()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = [dict(name=k, kind="build", reads=v, debug=True)
             for k, v in INPUTS.items()]
    return launch(tmp_path_factory.mktemp("ranks8"), N, cases)


def _jax(name, debug=None):
    jdist.DEBUG = debug
    try:
        return jdist.dist_build_bwt(
            JaxCollection.from_reads(INPUTS[name]), JaxConfig(), jax_mesh(N))
    finally:
        jdist.DEBUG = None


@pytest.mark.parametrize("name", ["rand", "repeat", "skewed"])
def test_matches_jax_and_golden(run, name):
    got = run.results()[name]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(INPUTS[name])))
    every_rank(got, _jax(name))


def _stages_equal(got, dbg):
    """Per shard is_sp and is_blue, per rank the node table (keys,
    counts, multi-in flags, local coordinates) equal the JAX tier's;
    the JAX rows past the rank's node count are its pads."""
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["dbg_is_sp"], dbg["is_sp"][r])
        np.testing.assert_array_equal(g["dbg_is_blue"], dbg["is_blue"][r])
        nn = g["dbg_node"].shape[0]
        jkey = keys_from_pair(dbg["node_hi"][r], dbg["node_lo"][r])
        np.testing.assert_array_equal(g["dbg_node"], jkey[:nn])
        np.testing.assert_array_equal(g["dbg_cnt"], dbg["cnt"][r][:nn])
        assert not dbg["cnt"][r][nn:].any()
        np.testing.assert_array_equal(g["dbg_multi_in"], dbg["multi_in"][r][:nn])
        np.testing.assert_array_equal(g["dbg_node_start"],
                                      dbg["node_start"][r][:nn])


def test_pathological_single_bucket(run):
    """Byte-correct, and the hot 8-char bucket is split: no rank owns
    more than 0.4 of the BWT, and each rank's segment is the JAX
    device's."""
    got = run.results()["pathological"]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(INPUTS["pathological"])))
    dbg = {}
    every_rank(got, _jax("pathological", dbg))
    seg = np.array([g["dbg_cnt"].sum() for g in got])
    np.testing.assert_array_equal(seg, dbg["cnt"].sum(axis=1))
    assert seg.max() <= 0.4 * seg.sum(), seg
    _stages_equal(got, dbg)


def test_split_index_dtypes_and_stages(run):
    """Shard-local int32 coordinates and SP indices on the devices, the
    SP string ranked sharded, and every stage equal to the JAX tier's."""
    got = run.results()["split"]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(INPUTS["split"])))
    dbg = {}
    every_rank(got, _jax("split", dbg))
    for g in got:
        assert g["dbg_node_start"].dtype == np.int32
        assert g["dbg_b_sidx"].dtype == np.int32
        assert bool(g["dbg_sharded_rank"])
    _stages_equal(got, dbg)
