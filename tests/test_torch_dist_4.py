"""The port's multi-device tier at 4 gloo ranks (one launch of
tests/torch_dist_worker.py): tests/test_dist.py's m sweep against the
JAX tier on the CPU mesh and golden, and the poly-T input on which the
JAX tier fails at m = 32."""

import numpy as np
import pytest

from debwt_tpu.parallel import dist_build_bwt as jax_dist
from debwt_tpu.parallel import make_mesh as jax_mesh
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.pipeline import build_bwt
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

from torch_dist_worker import every_rank, launch, poly_t_reads, rand_reads

N = 4
MS = (12, 24, 32)


def sweep_reads(m):
    return rand_reads(m, n=4, lo=40, hi=200)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = [dict(name=f"m{m}", kind="build", reads=sweep_reads(m), m=m)
             for m in MS]
    cases.append(dict(name="polyT", kind="build", reads=poly_t_reads(32), m=32))
    return launch(tmp_path_factory.mktemp("ranks4"), N, cases)


@pytest.mark.parametrize("m", MS)
def test_k_sweep(run, m):
    reads = sweep_reads(m)
    got = run.results()[f"m{m}"]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(reads)))
    every_rank(got, jax_dist(JaxCollection.from_reads(reads), JaxConfig(m=m),
                              jax_mesh(N)))


def test_poly_t_at_m32(run):
    reads = poly_t_reads(32)
    coll = SequenceCollection.from_reads(reads)
    want = golden_bwt(coll)
    every_rank(run.results()["polyT"], want)
    fused = build_bwt(coll, PipelineConfig(m=32), device="cpu")
    np.testing.assert_array_equal(fused.bwt6, want.bwt6)
    with pytest.raises(AssertionError):
        jax_dist(JaxCollection.from_reads(reads), JaxConfig(m=32), jax_mesh(N))
