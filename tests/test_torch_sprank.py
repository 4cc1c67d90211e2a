"""The port's sharded SP ranking (parallel.sprank.sp_ranks_sharded) at
8 gloo ranks on every input of tests/test_sprank.py: the same suffix
order as the port's single-device ranker (bluesort.sp_ranks)
and as the JAX sharded ranking on the 8-device CPU mesh, with all
ranks distinct. Ranks are order encodings: the comparison is of the
order they induce."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from debwt_tpu.parallel.mesh import make_mesh as jax_mesh
from debwt_tpu.parallel.sprank import sp_ranks_sharded as jax_sharded
from debwt_tpu_torch.bluesort import SP_CAP, sp_ranks

from torch_dist_worker import launch

N = 8


def _inputs():
    rng = lambda: np.random.default_rng(0)  # noqa: E731  (the rng fixture)
    deep = np.tile(np.array([0, 1, 2, 3], dtype=np.uint8), 600)
    deep[-1] = 5
    same = np.zeros(500, dtype=np.uint8)
    same[-1] = 5
    return {
        "random_small": rng().integers(0, 6, size=100).astype(np.uint8),
        "random_larger": rng().integers(0, 6, size=3001).astype(np.uint8),
        "repetitive_deep_ties": deep,
        "all_same_char": same,
        "tiny": np.array([1, 4, 2, 5], dtype=np.uint8),
        "block_boundary_exact_multiple":
            rng().integers(0, 6, size=8 * 64).astype(np.uint8),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = [dict(name=k, kind="sprank", sp6=v.tolist()) for k, v in INPUTS.items()]
    return launch(tmp_path_factory.mktemp("sprank8"), N, cases)


def _jax_ranks(sp6):
    L = sp6.shape[0]
    Pb = max(8, -(-L // N))
    full = np.zeros(N * Pb, dtype=np.uint8)
    full[:L] = sp6
    mesh = jax_mesh(N)
    blk = jax.device_put(jnp.asarray(full.reshape(N, Pb)),
                         NamedSharding(mesh, PartitionSpec("d")))
    return np.asarray(jax.device_get(jax_sharded(mesh, blk, L))).reshape(-1)[:L]


@pytest.mark.parametrize("name", list(INPUTS))
def test_sharded_ranks_give_the_suffix_order(run, name):
    sp6 = INPUTS[name]
    L = sp6.shape[0]
    got = run.results()[name]
    assert all("error" not in g for g in got), got
    ranks = np.concatenate([g["rank"] for g in got])[:L]
    assert np.unique(ranks).shape[0] == L
    order = np.argsort(ranks, kind="stable")
    single = sp_ranks(sp6, L, SP_CAP, "cpu", print).numpy()
    np.testing.assert_array_equal(order, np.argsort(single, kind="stable"))
    np.testing.assert_array_equal(order, np.argsort(_jax_ranks(sp6), kind="stable"))
